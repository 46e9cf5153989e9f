#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``chess_vision_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py [--seed 0] [--boards 300] [--bench-boards 1024]
                          [--profile-train N] [--profile-int8 N]
                          [--profile-arch]
                          [--checkpoint PATH] [--images DIR] [--keep-going]

``--checkpoint`` serves phases 5, 9, 14, 15 and 17's model with a trained
ViT-B/16 checkpoint's weights instead of random ones from ``--seed``;
``--images`` takes those phases' boards (and the int8 calibration's) from the
first images of a directory instead of random uint8; ``--keep-going`` prints
a failed check and goes on, and the run still fails at its end. Without
them (as the checks of a commit run it) the weights are random and the first
failed check ends the run.

Phases, one line each; any failure exits non-zero before the last line:
  1. device  card name, ``nvidia-smi`` name and power limit; TF32 off.
  2. build   nvcc builds ``chess_vision_tpu_torch/csrc/*.cu`` for sm_90a, one
             process per source, all started together; its seconds are
             printed, and the script's total seconds before the report.
  3. K1      preprocess kernel vs its plain version, (256,256,256,3) u8 -> bf16,
             bit for bit (the multiply and the add rounded apart, as the
             plain version's; a fused multiply-add was 1 bf16 ulp off).
  4. K2      attention kernel vs ``reference_attention`` at (256,257,2304) bf16
             with 12 heads, at (3,17,96) with 1 head, and at N = 17, 64, 65,
             264, 577 and 1025 with head dims 16, 32 and 64 (the 16-row and
             64-key edges, and sequences longer than any shared-memory
             tile), atol 2e-2; the scores it computes, ptxas's registers and
             spills and its shared memory per block printed.
  5. path    ViT-B/16 at 256 px, full width (embed 768, depth 12, 12 heads),
             bf16, weights drawn from --seed in the JAX layout and carried
             through the weight bridge; ``Predictor.predict_array`` on --boards
             random boards (a padded tail batch) must launch K1 once and K2 12
             times per batch, and agree with the same Predictor running the
             plain ops on the card (logits within SQUARES_ULPS units of each
             board's scale, FENs on confident squares; a planted fault
             outside); boards/s of both at batch 256. Then the same boards
             through ``Predictor(mode="ycbcr420")`` (planes converted on the
             host, RGB rebuilt on the card in PyTorch): K1 never and K2 12
             times a batch, checked against its plain ops the same way; its
             agreement with rgb mode, the bytes a batch sends, the
             conversion's time on the card and on the host, and boards/s of
             both modes in turns.
  6. K6/K7   row-quant kernel vs ``rowquant_plain`` at (65792, 768) ln and
             (65792, 3072) gelu_sigmoid, bf16 in: int8 codes within one
             level in under 1e-3 of the elements, scales rtol 1e-5; exact
             ties k + 0.5 round half to even.
  7. K8-K13  int8 GEMM kernel (wgmma main loop), every epilogue, vs its plain
             version at (65792, 768) -> 2304 / 768 / 3072 and (65792, 3072) ->
             768: codes and scales as in 6, bf16 outputs within one bf16 ulp;
             each GEMM's share of the int8 peak beside ``torch._int_mm``'s
             time; K8's time with each GELU beside the bias epilogue's on
             the same operands; K9's and K10's routes (``mm.res_route``: K9's
             thread-block cluster and how many the card holds at once, K10's
             grid, ptxas's registers and spills of both kernels); every
             epilogue at ragged shapes (M not a multiple of the tile's 64
             rows, O = 8k not of its 256 columns, K = 16k not of the stage's
             128 bytes, and O = 2304, where K9 takes the two-launch route)
             with the three GELUs; the epilogue's four-at-a-time GELU against
             the scalar GELU of the other kernels, bit for bit on 2^28 values
             per GELU.
  8. K4      quantizing attention vs ``reference_attention_quant`` at
             (256, 257, 2304) with the default bound shift and with a fixed
             shift,
             at (3, 17, 384) and at the ragged (2, 65, 2304) with 12 heads
             both ways: dequantized outputs within ATTN_ATOL; ptxas's
             registers and spills, its shared memory per block and how many
             clusters of 12 blocks (one per head) the card holds printed.
  9. int8    the same ViT-B/16 through ``Predictor(quant="int8")``, its
             softmax shifts calibrated on 8 boards (printed);
             ``predict_array`` on --boards boards must launch, per batch,
             the row quant once, the quantizing attention 12 times, the GEMM
             12 (qkv), 23 (proj, fc2), 12 (fc1) and 1 (last fc2) times, the
             preprocess once, and agree with the same Predictor on the plain
             versions on the card (logits within INT8_SQUARES_ULPS units of
             each board's scale); then every kernel call of one batch must
             meet the criteria of 6-8 against its plain version on the same
             inputs, the path's own activations (K4 dequantized within
             ATTN_LEVELS steps of its row); planted faults: K4's output from
             the next image and the last fc2 without its residual must fail
             the logits bound, K4's scales 2% off and its softmax scale 1.25x
             the per-op check (the softmax scale's logits reading printed);
             int8-vs-bf16 FEN agreement printed; the same in ycbcr420 mode
             (the counts less K1, every kernel call of a batch checked);
             boards/s of int8 kernel, int8 plain, int8 ycbcr420 and bf16
             kernel paths at batch 256. ``--profile-int8 N`` also prints a
             ``torch.profiler`` table of N boards through this Predictor
             (and, after phase 15, through the flat and fused ones) and
             requires one row-pass kernel a batch (the first LayerNorm's:
             K9 folds its own into its one launch).
 10. K3      attention backward kernel vs ``reference_attention_bwd`` at
             (256,257,2304) and (64,257,2304) with 12 heads and (3,17,96) with
             1 head, bf16: dq, dk and dv each within K3_ATOL, a planted fault
             (dK from the unscaled dS) outside it, two launches bit-identical;
             the same at N = 17, 64, 65, 257, 264 with head dims 16, 32, 64,
             and past 288 tokens, where the long route
             (``attention_bwd_cluster.cu``, thread-block clusters on
             ``long_plan``) takes the call, at N = 289 and 577 with those
             head dims and at (64, 577, 2304), whose time goes in the
             kernels line with SDPA's backward on the same values;
             the products it executes and ptxas's registers and its shared
             memory per block printed;
             ``scaled_dot_product_attention`` forward and backward timed on
             the same values as the library yardstick of K2 and K3.
 11. train   the same ViT-B/16 through the trainer's ``train`` function
             (``python -m chess_vision_tpu_torch.train`` calls it): the
             ``configs/vit.yaml`` values, batch 64, an in-memory corpus of 320
             random boards with labels from random FENs, 2 epochs of 4 steps,
             each followed by the eval epoch on the held-out 64; every train
             step must launch K2 12 times and K3 12 times (24 and 12 with
             remat), every eval step K2 12 times and K3 never; finite losses,
             the last epoch's mean train loss below the first's; the same
             corpus through ``train()`` on the packed transport four
             times, streaming and held on the card (``data.device_cache``)
             in turns (false, true, true, false), with equal per-epoch
             metrics, the same launches, the bytes a step sends and img/s of
             each on warm steps; one step with dropout and drop path off and fixed augmentation draws
             through the kernels and through the plain versions on the card:
             loss and per-tensor gradients within TRAIN_GRAD_RTOL; train
             img/s of both, peak device memory with and without remat; the
             checkpoint written and read back. ``--profile-train N`` also
             prints a ``torch.profiler`` table of N warm train steps.
 12. K5      flat quantizing attention vs ``reference_attention_quant_flat``
             at (73728, 2304) (256 images of 288 rows, 257 real) with the
             bound shift and with a fixed shift, and at a small ragged
             shape: real rows within ATTN_ATOL; real rows equal K4's on the
             unpadded values bit for bit; padded keys filled with large
             values change no real row. Then K11-K13, the flat layout's
             GEMMs, at its own 73,728 rows, checked and timed as in 7, with
             K9's route printed again.
 13. K14     the whole-block kernel on block 0 of phase 9's pack at
             (256, 257, 768) and on a small shape: bit-identical to the chain
             of split kernels it replaces and to a second launch; against
             ``fused_vit_block_plain`` within BLOCK_BOUNDS, a planted fault
             (the residual not rounded before the LN) outside them; its time
             beside the split chain's, taken in turns; its stages' times by
             the card's clock (``fused_block.STAGES``).
 14. flat    the ViT-B/16 of phase 9 through ``Predictor(quant="int8")``
             under CHESS_VISION_INT8_LAYOUT=flat: per batch the row quant
             once, the GEMM 12 + 23 + 12 + 1 times, K5 12 times, K4 never;
             logits and FENs against the same Predictor on the plain versions
             as in 9; every kernel call of one batch against its plain
             version; FEN agreement with the block layout.
 15. fused   the same under CHESS_VISION_INT8_LAYOUT=fused: per batch the row
             quant once, K14 11 times, and for the last block the GEMM
             1 + 1 + 1 + 1 times and K4 once; checked as 14; boards/s of the
             block, flat and fused layouts at batch 256, in turns.
 16. K15     the attention-variant sweep (``experiments.attn_variants.sweep``)
             at batch 256, which must launch each of the 8 variants 17 times
             and the row-quant kernel never (the kernel quantizes in its one
             launch; one call of each variant under ``torch.profiler`` must
             run one kernel and no row pass); each variant vs
             ``variant_plain`` at (256, 257, 2304) on randn values within its
             stated tolerance, ``bb=2`` bit-identical to ``bb=1``; its time
             beside the earlier design's reading (``K15_EARLIER_MS``) and
             ptxas's registers and spills printed.
 17. eval    evaluation on the card: 512 random boards with labels from random
             FENs (every eighth one legal=0) written as JPEGs with a
             ``manifest.csv`` in the generator's schema; ``evaluate.evaluate``
             at batch 256 on the model of phase 5 must launch K2 12 times per
             eval batch, its metrics and device sums must equal those
             recomputed on the host from the per-sample predictions, and its
             predictions must equal the plain-attention forward's on every
             square whose top-2 margin is above twice its board's bound
             (SQUARES_ULPS units of its scale); then, in
             subprocesses on phase 11's checkpoint, ``python -m
             chess_vision_tpu_torch.evaluate`` (its ``eval_results.jsonl``
             row checked) and ``python -m
             chess_vision_tpu_torch.experiments.int8_eval --calib 8`` under
             the block layout in ycbcr420 and rgb mode (its JSON parsed;
             agreement printed, not gated on these weights).
 18. cnn     ChessCNN (ConvNeXtV2-Tiny, depths 3-3-9-3, dims 96-768) at 256 px,
             bf16, drawn by ``init_weights`` from --seed (GRN's gamma and
             beta drawn N(0, 0.2)) and carried to the JAX layout and back
             through the weight bridge: ``Predictor.predict_array`` on
             --boards boards must launch K1 once a batch and no other
             kernel, with logits bit-equal to the same Predictor on the plain
             preprocess (cudnn.benchmark off); on 8 boards the card's logits
             against the port's f32 forward on the CPU within F32_UNITS of
             each board's scale, FENs equal on confident squares, and GRN's
             gamma and beta swapped (planted) outside the bound; ycbcr420
             mode launches nothing; boards/s of rgb and ycbcr420 in turns,
             peak memory (``--profile-arch`` also prints a
             ``torch.profiler`` table of one batch and, for the cnn, cuDNN's
             depthwise 7x7 timed at each stage's shape); then
             ``train()`` on ``configs/cnn.yaml`` values at batch 64, 2 epochs
             of 4 steps on phase 11's in-memory corpus: no kernel launched,
             finite losses, the mean train loss falling, warm-step img/s,
             the checkpoint read back, and ``python -m
             chess_vision_tpu_torch.evaluate`` on it in a subprocess, its
             ``eval_results.jsonl`` row equal to ``evaluate`` in process.
 19. square  ChessSquareCNN (MobileNetV4-Conv-Small at 0.5 width on 64 crops
             of 64 px, 2,925,183 parameters, BatchNorm at the init's
             statistics) checked as 18, the planted fault being the
             backbone's BatchNorm in batch-statistics mode; the trainer
             twice on ``configs/square.yaml`` values: pinned (every running
             statistic bit-equal to the init's after 8 steps, in the model
             and the checkpoint) and ``pin_backbone_bn=false`` (all 90 move,
             and the checkpoint carries them into the subprocess's
             evaluation).
 20. f32     K2 and K3 on f32 inputs (``csrc/attention_f32.cu``) vs their
             plain versions at (64, 257, 2304), 12 heads: within F32_ATOL, the backward bit-identical twice; their
             times beside the plain versions' and ``scaled_dot_product_
             attention``'s in f32; 4 train steps of ViT-B/16 at batch 64 with
             ``configs/vit.yaml`` values and ``training.mixed_precision=
             false`` (12 f32 K2 and 12 f32 K3 launches a step, none in
             bf16), one step's gradients against the plain attention's
             within F32_GRAD_RTOL, img/s and peak memory; an f32
             ``Predictor`` on phase 5's boards: K1 once and f32 K2 12 times
             a batch, FENs equal to its plain path's; the CNN and square
             archs in f32 (2 train steps, a batch served: finite, K1 once,
             no attention kernel). Also: the kernels (one thread-block
             cluster per (image, head), ``f32_plan``) at N = 1, 17, 65, 300,
             449 and 512 (8 CTAs, the cluster's limit) and 577 (past it: the
             backward's long route, the forward's 64-key windows) with head
             dims 16, 32 and 64, within F32_ATOL and the backward
             bit-identical twice; the backward one kernel launch a call
             (profiler); bound shares; the long route (the same kernel on
             clusters of up to 16 CTAs, ``long_plan``) at (16, 577, 2304),
             its kernels-line entry; ptxas's registers and spills; the f32
             step with ``model.remat=true`` (24 f32 K2 and 12 f32 K3 a step)
             in turns with false. (Another revision's f32 kernels are timed
             in turns with these by ``experiments/kernel_ab.py --sections
             k2f32,k3f32``.)
 21. remat   bf16 train steps at batch 64 under ``model.remat`` False,
             "attn_out" and True: (K2, K3) launches per step (12, 12),
             (12, 12) and (24, 12); the gradients of "attn_out" and True
             against False's (bit-equal printed, held to REMAT_GRAD_RTOL);
             img/s and peak memory of each, and the bytes an image
             "attn_out" keeps, beside ``models.ATTN_OUT_BYTES_PER_IMAGE``.
 22. multi   training over ranks on the one card: (a) ``python -m
             torch.distributed.run --nproc-per-node 1 -m
             chess_vision_tpu_torch.train`` (a 1-rank NCCL group) against
             the CLI without the launcher, both 1 epoch at full width and
             depth 2 on 160 JPEGs: checkpoints bit-equal; (b) two ranks on cuda:0 over gloo
             with CUDA tensors (NCCL refuses two ranks on one GPU),
             ``parallel.dryrun.compare_ranks``: DP2, FSDP2 and TP2 (6 heads
             a rank), 4 steps of ViT-B/16 bf16 at a global batch of 64,
             losses within TRAIN_LOSS_ATOL (the first step) and
             MULTI_LOSS_RTOL and parameters within AdamW's sign-flip bound
             of one rank, 99% of them within MULTI_P99; K2 and K3 launched
             12 times a step on each rank; a planted fault (dp2 without the
             gradient sum) must fail those bounds. Two ranks sharing one
             card: not a scaling. Then ``python -m
             chess_vision_tpu_torch.parallel.dryrun 2`` on the card: the
             graft entry's three surfaces (ViT-B/16 at 64 px).
 23. dp      ``Predictor(devices=["cuda:0", "cuda:0"])`` (two replicas, a
             shard each) in bf16 rgb and int8 block: FENs equal to one
             device's, the launch counts twice a batch's per shard; the
             ``serve`` CLI with ``--dp``; ``evaluate`` over two replicas
             on phase 17's boards, its report equal to one device's.
 24. p384    ViT-B/16 at full width trained at ``model.input_size=384``
             (577 tokens, where K3 takes its long routes): ``train()`` on
             ``configs/vit.yaml`` values, batch 64, remat off, one epoch of 4
             steps on 320 random boards resized to 384 px as the loader
             resizes, with labels from random FENs: every train step must
             launch K2 12 times and K3 12 times, every one on the ``long``
             route, every eval step K2 12 times and K3 never; finite losses;
             one step with dropout and drop path off and fixed augmentation
             draws through the kernels and through plain attention: loss
             within TRAIN_LOSS_ATOL and per-tensor gradients within
             TRAIN_GRAD_RTOL; warm-step img/s and peak device memory. Then
             the same in f32 (``training.mixed_precision=false``) at batch
             16 on 80 boards: 12 f32 K2 and 12 f32 K3 a step, every K3 on
             ``f32_long``, gradients within F32_GRAD_RTOL. The phase's
             seconds.
 25. head dims  weights from ``.pth`` and K2/K3 at head dims 80 and 128.
             (a) a random timm-layout ViT-B/16 backbone at 224 px from --seed,
             saved with ``torch.save``, reaches ``train()`` through
             ``model.pretrained_path`` (batch 64, 2 steps): before the first
             step the backbone equals ``convert.timm.backbone_state_dict``'s
             bit for bit, ``pos_embed`` at 16 x 16, and the steps launch K2
             and K3; a random reference ``.pth`` (``model`` and ``config``)
             goes through ``python -m chess_vision_tpu_torch.convert.timm``
             into ``Predictor``: its FENs on --boards boards equal those of
             the same weights loaded straight; a ``.pth`` without one tensor
             is refused. (b) K2 and K3, bf16 and f32, at head dims 80 (16
             heads) and 128 (6 heads) at (64, 257, 3 D) and on the long routes
             at (16, 577, 3 D), against their plain versions within the bounds
             of head dim 64, every backward twice bit-identical; times by
             CUDA events beside plain and SDPA's; routes, plans, ptxas's
             registers and spills, shared memory. (c) ViT-Huge's widths
             (1280 wide, 16 heads of 80; 16 of its 32 blocks) at 256 px with
             random weights: bf16 ``Predictor`` on --boards boards at batch
             256 held to plain as phase 5 (16 K2 a batch); ``train()`` in bf16
             at batch 64 for 4 steps (16 K2 and 16 K3 on the cluster route a step,
             its checkpoint left out), warm img/s and peak memory; one bf16
             step at batch 64 and one f32 step at batch 16 against plain
             attention within TRAIN_GRAD_RTOL and F32_GRAD_RTOL. (d)
             ``train()`` with ViT-B/16's widths on 6 heads of 128, bf16,
             batch 64, 2 steps: every K3 on the cluster route. The phase's
             seconds.
 26. any head dim  K2 and K3 at the head dims the instantiated kernels do
             not take, run by ``csrc/attention_any.cu`` (forward) and
             ``csrc/attention_any_bwd.cu`` (backward, one launch on a
             thread-block cluster a head up to 1,024 tokens, counted once a
             call in ``ANY_BWD_LAUNCHES``). (a) bf16 and f32 at
             head dims 1, 3, 12, 20, 36, 100, 136, 192, 256, 384, 768, 1,024
             and 1,100 (2 images, 257 tokens, 2 heads; above 256 the tiles
             hold the depth 256 columns at a time), and at 12 (64 heads),
             256 (3 heads) and 1,024 (1 head) also at 577 and 1,100 tokens,
             against their plain
             versions within the bounds of head dim 64, every backward twice
             bit-identical, every call counted in its dtype's counter and in
             ``ANY_LAUNCHES`` / ``ANY_BWD_LAUNCHES``; times by CUDA events at
             (64, 257, 2304) on 3 heads of 256 and 64 heads of 12, bf16 and
             f32, beside the bound, plain and SDPA's; each shape's plan
             (column chunks and columns, backward clusters, CTAs and keys a
             CTA); ptxas's registers and spills of every any-head-dim
             kernel. (b)
             ViT-B/16's widths (768 wide, 12 blocks, MLP 3072, 256 px) on 3
             heads of 256 with random weights: bf16 ``Predictor`` on
             --boards boards at batch 256 held to plain as phase 5 (12 K2 a
             batch), boards/s; ``train()`` in bf16 at batch 64 for 4 steps
             (12 K2 and 12 K3 a step, every one an any-head-dim launch; its
             checkpoint left out), warm img/s and peak memory; one bf16 step
             at batch 64 and one f32 step at batch 16 against plain attention
             within TRAIN_GRAD_RTOL and F32_GRAD_RTOL. (c) the same on 64
             heads of 12. The phase's seconds.
 27. modes   the int8 path's serving modes and the hybrid and xla layouts
             at full width, without calibration (every softmax on its mode's
             shift). (a) K4 and K5 at (256, 257, 2304) and (73728, 2304) in
             each mode (the bound, the JAX default; a fixed shift of 24; the
             row max; the bf16 exp; the int8 QK^T leg; the int8 P V leg
             alone; both int8 legs; the legs' ``attention_quant_i8_kernel``,
             ptxas printed) against their plain versions: dequantized within
             ATTN_LEVELS steps of each row (with the bf16 exp, all but
             EXP_BF16_ROWS of the rows, and those within EXP_BF16_LEVELS;
             the kernel's f32 exp against the plain bf16 exp, a planted
             fault, outside that); an overshooting bound's rows zeros in
             both, and the bound without its -45 (a planted fault, the plain
             version with BOUND_OFFSET 0) outside the bound; K8 in the bf16 epilogue with
             each GELU within one level (its time in turns with the f32
             epilogue's); K7's none and GELU forms, which the hybrid layout
             runs, against their bytes bound. (b) ``Predictor(quant="int8")``
             under each of MODE_PATHS (the bound in the block, flat and fused
             layouts; fixed, max, int8, int8pv, the bf16 exp and the bf16
             epilogue in the block layout; hybrid; xla) serves two batches of
             256 with the counts set to 0 just before and read after (the
             hybrid layout: K2 12, K7 48 and the product 48 times a batch, no
             K4 or K8-K10; xla: K2 alone), every int8 kernel call of one
             batch against its plain version, logits within
             INT8_SQUARES_ULPS of the plain path's; under fused, K14 with the
             bound on block 0 against its plain version and bit-identical to
             the split chain, timed in turns with a fixed shift. Every kernel
             time by (kernel, mode) and the phase's seconds.
 28. long legs  the int8 legs' long route (``attention_quant_long.cu``:
             the head streamed through shared memory in 64-key tiles, past
             the short route's shared memory). (a) K4 and K5 in the three
             forms (int8, pv only, int8pv) at head dim 64 on 2 images of
             961, 1,057, 1,505, 1,601 and 2,305 keys (2-12 heads) and at
             head dims 16 and 32 just past qk_int8's limit (2,721 and 1,729
             keys), each on ``i8_plan``'s route with one launch a call
             counted on it, against their plain versions within
             ATTN_LEVELS steps (K5 at 1,601 keys with padded V rows nine
             times the real ones, which V's column scales see); the two
             routes bit for bit at 257 keys (every form) and 1,504 (both
             legs). (b) K4 at (256, 1601, 2304) and K5 at (256 * 1632,
             2304) in the three forms, times by CUDA events beside the bound
             (the products and the bytes) and the plain version's time on
             LONG_CHECK images, the first LONG_CHECK images against it;
             the two routes in turns at 257, 960 and 1,504 keys; ptxas's
             registers and spills of every long instantiation. (c)
             ViT-B/16 served in int8 at 640 px (1,601 tokens), random
             weights, 2 batches of 256 boards a mode, uncalibrated: the
             bound in the block layout (K4's own kernel, no legs), then
             CHESS_VISION_ATTN_QK int8 and int8pv in the block (K4) and flat
             (K5, 1,632 rows an image) layouts, each checked as phase 27b
             checks a mode on LONG_CHECK boards, 12 legs launches a batch,
             every one on the long route; boards/s of each; the fused
             layout under int8pv serves one batch as the block layout. The
             phase's seconds.
 29. report  the kernels JSON line (every kernel with its bound and, where
             one PyTorch call computes the same function, that call's time;
             every kernel must have been launched by a main path: K3's long
             routes by phase 24's, the head dims 80 and 128 by phase 25's,
             the any-head-dim kernels by phase 26's, the int8 legs and K8's
             bf16 epilogue by phase 27's, the legs' long route by phase
             28's), the nvidia-smi line, then {"ok": true, "device": {...}}.

Bounds: ``bound_ms`` is the larger of the bytes a call must move (inputs
read once, outputs written once) over 3.35 TB/s and its operations over the
card's peak for their type (989 TFLOP/s bf16, 1,979 TOP/s int8, 67 TFLOP/s
f32), the H100 SXM's published rates at its full 700 W.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from contextlib import ExitStack, contextmanager, nullcontext
from unittest import mock

import numpy as np

# Logits of a kernel path vs its plain path on the card are held per board
# (a row of 832 square logits) in units of the row's scale: its RMS logit
# over 256, about one bf16 ulp at that magnitude (``row_unit``), so that one
# bound holds at the random model's logit scale (RMS 0.44-0.74 over phase
# 5's boards) and at a trained one's. bf16: the two attentions round at other
# points (the kernel's probabilities are unrounded f32 in its row sums) and
# the differences pass through 12 bf16 blocks; read on the H100 at seed 0:
# 12.6 (rgb) and 12.7 (ycbcr420) units. At 16 units no row of the random
# run gets more than 0.046 (the absolute bound it replaced was 0.05).
SQUARES_ULPS = 16
# int8: a code may land one level apart where a value sits on a rounding
# boundary (sums in another order; ~1e-6 of the elements measured in phases
# 6-8), which moves that output by one quantization step of its row, and 48
# requants through 12 blocks spread it: read 25.0 (rgb) and 22.2 (ycbcr420)
# units at seed 0. This bound only fails gross faults (K4's output from
# another image, a dropped residual: planted in phase 9); the per-op check of
# phase 9 (path_op_checks) fails the subtler ones (K4's scales 2% off, its
# softmax scale 1.25x: planted there). At 32 units no row of the random run
# gets more than 0.093 (the absolute bound it replaced was 0.1).
INT8_SQUARES_ULPS = 32
ATTN_ATOL = 2e-2  # the JAX package's bound for its own kernel
# K4/K5 on the path, dequantized, per row in quantization steps of the row
# (max |q s - q' s'| / max(s, s')): one level where a code flips, and up to
# 0.35 of a level from the two scales' difference (127 times their relative
# difference, which reads 3e-4 to 8e-4 here and 1.4e-3 on trained weights).
# Read 1.000-1.010 steps at seed 0; no row of that run gets more than 0.0198
# (ATTN_ATOL, which the kernel calls of phases 4, 8 and 12 keep, is 0.02).
ATTN_LEVELS = 1.35
# K4/K5 with the bf16 exp (CHESS_VISION_ATTN_EXP=bf16), per row: the share of
# rows beyond ATTN_LEVELS. exp(bf16(s - shift)) rounds its argument to steps
# of 1/8 to 1/4 at the shifts of the bound (s - shift of 16 to 64); the
# kernel's scores (mma.sync) and the plain version's (cuBLAS) add their
# products in other orders and differ in the last bit, so a score next to
# a step boundary lands a step apart and its p e^(+-1/4) apart: a row whose
# heaviest key does so moves by up to a quarter of its largest value. The
# per-row bound holds elsewhere; such rows stay rare (1.37e-4 of them at
# seed 0 on the H100).
EXP_BF16_ROWS = 1e-3
# ... and those rows within EXP_BF16_LEVELS steps: a quarter of a row's
# largest value is 32 of its steps (read 4 to 15 on the H100). The planted
# fault, the kernel's f32 exp against the plain version's bf16 one, must
# fail the pair.
EXP_BF16_LEVELS = 32.0
# K3 vs its plain version, per output element: both round dS and pn to bf16
# and each output once from f32 sums taken in another order, so values near a
# rounding boundary land one bf16 ulp apart: 3.9e-3 read at |values| up to 2.8
# (ulp 7.8e-3 in [1, 2), 1.6e-2 in [2, 4)). The planted fault, dK made from
# the unscaled dS, reads 4.5 to 19.8. The JAX package holds its own kernel to
# 5e-2 against an f32 reference.
K3_ATOL = 1.6e-2
# gradients of one train step, kernel path vs plain path on the card, per
# parameter tensor: max |difference| over max |plain gradient|. bf16 rounds at
# other points in the two attentions (K2's unrounded row sums, K3's f32
# rounding order), and the differences pass back through up to 12 bf16 blocks.
# Read on the H100 at seed 0: worst tensor 0.018 (the CLS token), median
# 0.004, losses 2.8e-4 apart.
TRAIN_GRAD_RTOL = 4e-2
TRAIN_LOSS_ATOL = 5e-3
# f32 K2/K3 vs their plain versions: IEEE f32 on both sides, sums in another
# order (the kernels' online max over 64-key tiles); read on the H100 at
# 1.1e-6 (forward) and 3.6e-7 (backward) on values up to 1.7
F32_ATOL = 5e-6
# gradients of one f32 train step, f32 kernels vs plain attention on the
# card, per tensor (max |difference| / max |plain gradient|): f32 rounding
# through 12 blocks
F32_GRAD_RTOL = 1e-3
# "attn_out" and full remat against no remat: the same ops on the same
# values, recomputed; dropout and drop path redrawn from the restored state
REMAT_GRAD_RTOL = 1e-6
# two ranks against one over 4 bf16 steps (phase 22): the first step's loss
# (the same weights) within TRAIN_LOSS_ATOL; every step's within this
# relative bound: the ranks' bf16 products round at other points (TP adds
# two partial products; DP runs 32-row GEMMs) and 4 steps of AdamW at lr
# 1e-4 without warm-up amplify it (losses 4.5 -> 11.9 -> 7.1); read on the
# H100: 2.9e-3 at most (tp2's fourth step), 4e-4 on the first
MULTI_LOSS_RTOL = 1e-2
# ... and 99% of the parameters within this of one rank's after the 4 steps.
# The maximum only holds AdamW's sign flips (a gradient entry near 0 whose
# sign differs moves its parameter by up to 2 lr a step either way; read up
# to 5.1e-4 of the bound's 8e-4), so this is what sees a fault in the
# reduction. Sound runs read 4.1e-6 to 1.3e-5 on the H100 (dp2, fsdp2, tp2).
MULTI_P99 = 5e-5
# K14 (and the split chain, which gives the same bits) vs
# ``fused_vit_block_plain`` over a whole block: each of the block's four
# row quants may put a code one level apart where a value sits on a rounding
# boundary (~1e-6 to 1e-4 of the elements, phases 6-8), and such a code moves
# its whole row a little through the products and LayerNorms that follow. So
# the block's outputs are held to shares, not to one level everywhere: x more
# than one bf16 ulp off, and codes that differ, each in under BLOCK_SHARE of
# the elements; codes at most BLOCK_LEVELS apart; scales within
# BLOCK_SCALE_RTOL. Read on the H100 over the 11 blocks of the served model:
# shares up to 0.0032 and 0.0016, 3 levels, scales 0.009. The planted fault
# (LN2 reading the unrounded residual) reads shares of 0.16-0.53 and
# 0.09-0.30 and falls outside; its levels and scales do not tell it apart.
BLOCK_SHARE = 2e-2
BLOCK_LEVELS = 4
BLOCK_SCALE_RTOL = 2e-2
# K15 vs ``variant_plain``, dequantized, per variant: 2e-2 as K4; bf16s rounds
# scores, differences and exponentials to bf16, so a last-bit difference in a
# sum becomes a bf16 step of p
VARIANT_ATOL = {"bf16s": 4e-2}
# K15's times a call at (256, 257, 2304) in the earlier design (a 4-warp tile
# per 64 rows, an f32 scratch and a row-pass launch), ms on the H100 80GB
# HBM3 at 700 W: printed beside this run's for the reader, never compared
K15_EARLIER_MS = {"base": 1.3138, "foldscale": 1.2960, "noshift": 0.8690,
                  "noexp": 1.2769, "fexp": 1.3298, "fexp_ns": 1.0049,
                  "bf16s": 1.3566, "normbound": 1.2766}
BATCH = 256
SIZE = 256
TRAIN_BATCH = 64
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


class SmokeFailure(Exception):
    pass


# failed checks under --keep-going; None: the first failed check raises
FAILED: list | None = None


def require(cond: bool, what: str) -> None:
    if cond:
        return
    if FAILED is None:
        raise SmokeFailure(what)
    FAILED.append(what)
    print(f"CHECK FAILED: {what}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(fn, iters: int) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_entry(name: str, source: str, replaces: str, err: float, ms: float,
                 plain_ms: float, nbytes: float, ops, op_type: str | None = None,
                 library_ms: float | None = None) -> dict:
    """One entry of the kernels line; the bound from this run's shapes.
    ``ops`` is a count of ``op_type`` operations, or {type: count} for a
    kernel that works in more than one type (their times add)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    counts = ops if isinstance(ops, dict) else {op_type: ops}
    by_ops = sum(n / PEAK_OPS[t] for t, n in counts.items()) * 1e3
    return {"name": name, "route": "cuda",
            "source": "chess_vision_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": library_ms}


def bf16_ulps(a, b) -> float:
    import torch

    a, b = a.float(), b.float()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(1e-30))) - 7)
    return ((a - b).abs() / ulp).max().item()


def row_unit(logits: np.ndarray) -> np.ndarray:
    """Each row's scale unit, its RMS over 256 (a bf16 ulp at that
    magnitude is 1/256 to 1/128 of it): (rows, n) -> (rows,)."""
    return np.sqrt(np.square(logits, dtype=np.float64).mean(axis=1)) / 256


def logits_reading(logits_k: dict, logits_p: dict, ulps: float) -> dict:
    """Square logits of a kernel path against its plain path: the worst
    row's max |difference| in units of its scale (``row_unit``), the per-row
    bound that makes, and the largest absolute difference."""
    sq_k, sq_p = logits_k["squares"], logits_p["squares"]
    ulp = row_unit(sq_p)
    err = np.abs(sq_k - sq_p).max(axis=1)
    return {"ulps": float((err / ulp).max()), "bound": ulps * ulp,
            "max_abs": float(err.max()), "ok": bool((err <= ulps * ulp).all())}


def require_logits(tag: str, fens, fens_plain, logits_k: dict, logits_p: dict,
                   ulps: float) -> None:
    """The kernel path's logits within ``ulps`` of the plain path's, row by
    row (``logits_reading``), and its FENs equal on every square and turn
    whose top-2 margin is above twice its row's bound."""
    from chess_vision_tpu_torch import fen_to_labels

    n = len(fens)
    sq_k, sq_p = logits_k["squares"], logits_p["squares"]
    require(sq_k.shape == (n, 64 * 13) and np.isfinite(sq_k).all(),
            f"{tag} logits: shape {sq_k.shape}, finite {np.isfinite(sq_k).all()}")
    r = logits_reading(logits_k, logits_p, ulps)
    require(len(fens_plain) == n, "FEN count")
    ids_k = np.stack([fen_to_labels(f.split()[0]) for f in fens])
    ids_p = sq_p.reshape(-1, 64, 13).argmax(-1)
    top2 = np.sort(sq_p.reshape(-1, 64, 13), axis=-1)[..., -2:]
    confident = top2[..., 1] - top2[..., 0] > 2 * r["bound"][:, None]
    mismatch = int((ids_k != ids_p)[confident].sum())
    turn_k = np.array([f.split()[1] == "b" for f in fens])
    turn_p = logits_p["turn"][:, 0]
    turn_conf = np.abs(turn_p) > 2 * r["bound"]
    turn_mismatch = int((turn_k != (turn_p > 0))[turn_conf].sum())
    same = sum(a == b for a, b in zip(fens, fens_plain))
    print(f"{tag} squares logits kernel vs plain: worst row {r['ulps']:.2f} "
          f"units of its scale (RMS/256; bound {ulps}; per-row bounds "
          f"{r['bound'].min():.4g}-{r['bound'].max():.4g}); max |diff| "
          f"{r['max_abs']}; {int(confident.sum())} of "
          f"{confident.size} squares have top-2 margin > twice their row's "
          f"bound, {mismatch} differ; turn mismatches on confident boards "
          f"{turn_mismatch}; {same}/{n} FEN strings identical", flush=True)
    require(r["ok"], f"{tag} squares logits differ by {r['ulps']} units of "
                     f"their row's scale (bound {ulps})")
    require(mismatch == 0 and turn_mismatch == 0,
            f"{tag} FENs differ on confident squares or turns")


def planted_reading(tag: str, what: str, logits_f: dict, logits_p: dict,
                    ulps: float) -> bool:
    """A planted fault's logits against the plain path's, printed; whether
    the per-row bound fails it."""
    r = logits_reading(logits_f, logits_p, ulps)
    print(f"{tag} planted fault ({what}): worst row {r['ulps']:.1f} units "
          f"(bound {ulps}: {'fails' if not r['ok'] else 'PASSES'}); max |diff| "
          f"{r['max_abs']}", flush=True)
    return not r["ok"]


def require_planted(tag: str, what: str, logits_f: dict, logits_p: dict,
                    ulps: float) -> None:
    """A planted fault's logits against the plain path's: the per-row bound
    must fail it."""
    require(planted_reading(tag, what, logits_f, logits_p, ulps),
            f"{tag} the planted fault ({what}) passes the bound")


def random_jax_params(cfg: dict, seed: int) -> dict:
    """ChessViT params in the JAX package's tree layout: trunc-normal(0.02)
    kernels and pos_embed (chess_vision_tpu/models/layers.py), zero biases and
    cls_token, unit LayerNorm scales."""
    m = cfg["model"]
    D, depth, size = m["embed_dim"], m["depth"], m["input_size"]
    hidden = int(D * m["mlp_ratio"])
    rng = np.random.default_rng(seed)

    def tn(*shape):
        # truncated at 2 sigma, rescaled to std 0.02 as flax's initializer
        z = np.clip(rng.standard_normal(shape, dtype=np.float32), -2.0, 2.0)
        return z * np.float32(0.02 / 0.87962566)

    def dense(i, o):
        return {"kernel": tn(i, o), "bias": np.zeros(o, np.float32)}

    def norm():
        return {"scale": np.ones(D, np.float32), "bias": np.zeros(D, np.float32)}

    backbone = {
        "patch_embed": {"kernel": tn(16, 16, 3, D), "bias": np.zeros(D, np.float32)},
        "cls_token": np.zeros((1, 1, D), np.float32),
        "pos_embed": tn(1, (size // 16) ** 2 + 1, D),
        "norm": norm(),
    }
    for i in range(depth):
        backbone[f"block{i}"] = {
            "norm1": norm(), "norm2": norm(),
            "attn": {"qkv": dense(D, 3 * D), "proj": dense(D, D)},
            "mlp": {"fc1": dense(D, hidden), "fc2": dense(hidden, D)},
        }
    return {"backbone": backbone, "type_head": dense(D, 7),
            "color_head": dense(D, 3), "turn_head": dense(D, 1),
            "castling_head": dense(D, 4)}


FULL_WIDTH = {"arch": "vit", "name": "vit_base_patch16_224.augreg_in21k",
              "input_size": SIZE, "embed_dim": 768, "depth": 12,
              "num_heads": 12, "mlp_ratio": 4.0}


def mean_std(cfg: dict) -> tuple:
    """The model's input normalization (mean, std), per channel."""
    from chess_vision_tpu_torch.config import get_data_config

    data_cfg = get_data_config(cfg["model"]["name"])
    return data_cfg["mean"], data_cfg["std"]


def path_model(args) -> tuple[dict, dict]:
    """The config and JAX-layout params of the served ViT-B/16 (phases 5, 9,
    14, 15 and 17): random from --seed, or --checkpoint's, which must hold
    the same full-width model."""
    cfg = {"model": dict(FULL_WIDTH), "training": {"mixed_precision": True}}
    if args.checkpoint is None:
        return cfg, random_jax_params(cfg, args.seed)
    from chess_vision_tpu_torch.utils.checkpoint import load_checkpoint

    ckpt = load_checkpoint(args.checkpoint)
    model = ckpt["config"]["model"]
    defaults = {"arch": "vit", "input_size": 224, "embed_dim": 768,
                "depth": 12, "num_heads": 12, "mlp_ratio": 4.0}
    other = {k: model.get(k, defaults.get(k)) for k in FULL_WIDTH
             if model.get(k, defaults.get(k)) != FULL_WIDTH[k]}
    require(not other, f"--checkpoint is not ViT-B/16 at {SIZE} px: {other}")
    return cfg, ckpt["params"]


def path_boards(args, rng, count: int) -> np.ndarray:
    """``count`` boards: random uint8 from ``rng``, or the first images of
    the --images directory (its manifest's order, else by name), decoded as
    the loader decodes them."""
    if args.images is None:
        return rng.integers(0, 256, (count, SIZE, SIZE, 3), dtype=np.uint8)
    from chess_vision_tpu_torch.data import ChessDataset

    dataset = ChessDataset(args.images, max_samples=count, input_size=SIZE)
    require(len(dataset) == count, f"{len(dataset)} images in {args.images}, "
                                   f"want {count}")
    return np.stack([dataset.load_image(i) for i in range(count)])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--boards", type=int, default=300)
    parser.add_argument("--bench-boards", type=int, default=4 * BATCH)
    parser.add_argument("--profile-train", type=int, default=0,
                        help="also profile this many warm train steps")
    parser.add_argument("--profile-int8", type=int, default=0,
                        help="also profile this many boards through each "
                             "int8 layout")
    parser.add_argument("--profile-arch", action="store_true",
                        help="also profile one batch of the cnn and square "
                             "forwards and time cuDNN's depthwise 7x7")
    parser.add_argument("--checkpoint", default=None,
                        help="serve phases 5, 9, 14, 15 and 17 with this "
                             "ViT-B/16 checkpoint's weights")
    parser.add_argument("--images", default=None,
                        help="take those phases' boards from the first "
                             "images of this directory")
    parser.add_argument("--keep-going", action="store_true",
                        help="print a failed check and go on; the run fails "
                             "at its end")
    args = parser.parse_args()
    global FAILED
    FAILED = [] if args.keep_going else None

    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch sees no CUDA device", file=sys.stderr)
        return 2
    from chess_vision_tpu_torch.config import get_data_config
    from chess_vision_tpu_torch.experiments.plain import forward_logits
    from chess_vision_tpu_torch.ops import _build
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import preprocess as pre_ops
    from chess_vision_tpu_torch.serve import Predictor

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    started = time.perf_counter()

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1 device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; tf32 off", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"[2 build] {time.perf_counter() - t0:.1f} s -> {_build.LIB_PATH}",
          flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip(), file=sys.stderr)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    data_cfg = get_data_config("vit_base_patch16_224.augreg_in21k")
    mean, std = data_cfg["mean"], data_cfg["std"]
    kernels = {}

    # 3. K1
    u8 = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=torch.uint8,
                       device=dev, generator=gen)
    out_k = pre_ops.preprocess_u8(u8, mean, std, torch.bfloat16)
    out_p = pre_ops.preprocess_u8_plain(u8, mean, std, torch.bfloat16)
    torch.cuda.synchronize()
    ulps = bf16_ulps(out_k, out_p)
    err = (out_k.float() - out_p.float()).abs().max().item()
    ms = cuda_ms(lambda: pre_ops.preprocess_u8(u8, mean, std), 50)
    plain_ms = cuda_ms(lambda: pre_ops.preprocess_u8_plain(u8, mean, std), 50)
    print(f"[3 K1] preprocess {tuple(u8.shape)} u8->bf16: max |diff| {err} "
          f"({ulps} bf16 ulp); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
          flush=True)
    require(torch.equal(out_k, out_p),
            f"K1 is {ulps} bf16 ulp from its plain version")
    kernels["preprocess_u8"] = kernel_entry(
        "preprocess_u8", "preprocess.cu",
        "chess_vision_tpu/ops/preprocess.py:43", err, ms, plain_ms,
        nbytes=3 * u8.numel(), ops=2 * u8.numel(), op_type="f32")

    # 4. K2: the path's shape, then the ragged edges and long sequences
    N = SIZE // 16 * SIZE // 16 + 1
    odd = [(2, n, 2, Dh) for n in (17, 64, 65, 264, 577, 1025)
           for Dh in (16, 32, 64)]
    for B, n, H, Dh in ((BATCH, N, 12, 64), (3, 17, 1, 32), *odd):
        qkv = torch.randn((B, n, 3 * H * Dh), device=dev,
                          generator=gen).to(torch.bfloat16)
        out_k = attn_ops.fused_qkv_attention(qkv, H)
        out_p = attn_ops.reference_attention(qkv, H)
        torch.cuda.synchronize()
        err = (out_k.float() - out_p.float()).abs().max().item()
        finite = bool(torch.isfinite(out_k).all())
        require(finite and err <= ATTN_ATOL,
                f"K2 at {tuple(qkv.shape)}: max |diff| {err}, finite {finite}")
        if B != BATCH:
            print(f"  [4 K2] attention {tuple(qkv.shape)} H={H}: max |diff| "
                  f"{err}", flush=True)
            continue
        ms = cuda_ms(lambda: attn_ops.fused_qkv_attention(qkv, H), 20)
        plain_ms = cuda_ms(lambda: attn_ops.reference_attention(qkv, H), 5)
        kernels["fused_qkv_attention"] = kernel_entry(
            "fused_qkv_attention", "attention.cu",
            "chess_vision_tpu/ops/attention.py:90", err, ms, plain_ms,
            nbytes=2 * qkv.numel() * 4 // 3, ops=4 * B * H * n * n * Dh,
            op_type="bf16")
        print(f"[4 K2] attention {tuple(qkv.shape)} H={H}: max |diff| {err}; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{kernels['fused_qkv_attention']['bound_ms']:.4f} ms; "
              f"{flash_work('attention_fwd_kernel', n, Dh)}", flush=True)
        del qkv, out_k, out_p
    del u8

    # 5. full path
    cfg, params = path_model(args)
    depth = cfg["model"]["depth"]
    t0 = time.perf_counter()
    predictor = Predictor((cfg, params), batch_size=BATCH, device="cuda")
    rng = np.random.default_rng(args.seed)
    boards = path_boards(args, rng, args.boards)
    predictor.predict_array(boards[:BATCH])  # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    pre_ops.LAUNCHES = 0
    attn_ops.LAUNCHES = 0
    fens = predictor.predict_array(boards)
    launches = {"preprocess_u8": pre_ops.LAUNCHES,
                "fused_qkv_attention": attn_ops.LAUNCHES}
    batches = math.ceil(args.boards / BATCH)
    print(f"[5 path] ViT-B/16 {SIZE}px bf16 full width, {args.boards} boards "
          f"in {batches} batches of {BATCH}: launches {launches} "
          f"(set-up {setup_s:.1f} s); weights {args.checkpoint or 'random'}, "
          f"boards {args.images or 'random'}", flush=True)
    require(launches == {"preprocess_u8": batches,
                         "fused_qkv_attention": depth * batches},
            f"launch counts {launches} for {batches} batches")
    for name, count in launches.items():
        kernels[name]["launches"] = count

    with plain_ops(attn_ops, pre_ops):
        fens_plain = predictor.predict_array(boards)
    require(pre_ops.LAUNCHES == batches and attn_ops.LAUNCHES == depth * batches,
            "the plain-ops run launched a kernel")

    logits_k = forward_logits(predictor, boards)
    with plain_ops(attn_ops, pre_ops):
        logits_p = forward_logits(predictor, boards)
    require(len(fens) == args.boards, "FEN count")
    require_logits("[5 path]", fens, fens_plain, logits_k, logits_p,
                   SQUARES_ULPS)
    # planted: K2's output taken from the next image of the batch
    rolled = lambda qkv, h: attn_ops.reference_attention(  # noqa: E731
        qkv, h).roll(1, dims=0)
    with mock.patch.object(attn_ops, "fused_qkv_attention", rolled):
        logits_f = forward_logits(predictor, boards[:BATCH])
    require_planted("[5 path]", "K2's output from the next image", logits_f,
                    {k: v[:BATCH] for k, v in logits_p.items()}, SQUARES_ULPS)

    bench = np.concatenate([boards] * math.ceil(args.bench_boards / args.boards))
    bench = bench[:args.bench_boards]
    rates = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        with plain_ops(attn_ops, pre_ops) if which == "plain" else nullcontext():
            t0 = time.perf_counter()
            predictor.predict_array(bench)
            rates[which].append(len(bench) / (time.perf_counter() - t0))
    print(f"[5 path] predict_array boards/s at batch {BATCH} "
          f"({len(bench)} boards per run; kernel, plain, plain, kernel): "
          f"kernel {rates['kernel']}, plain {rates['plain']}; {kind}, {smi}",
          flush=True)
    ycbcr_path_phase(args, cfg, params, boards, fens, predictor, kind, smi)

    int8_kernel_phases(dev, kernels)
    int8 = int8_path_phase(args, cfg, params, boards, fens, predictor, kernels,
                           kind, smi)
    del predictor
    torch.cuda.empty_cache()
    attention_bwd_phase(args, dev, kernels)
    # phase 11's checkpoint stays in the work directory for phase 17
    workdir = tempfile.mkdtemp(prefix="cvt_smoke_")
    try:
        train_ckpt = train_path_phase(args, kernels, kind, smi, workdir)
        layout_kernel_phases(args, dev, int8, kernels)
        flat = layout_path_phase(14, "flat", args, cfg, params, boards, int8,
                                 kernels)
        fused = layout_path_phase(15, "fused", args, cfg, params, boards, int8,
                                  kernels)
        layout_bench(args, boards, {"block": int8["predictor"], "flat": flat,
                                    "fused": fused}, kind, smi)
        del int8, flat, fused
        torch.cuda.empty_cache()
        variant_sweep_phase(args, dev, kernels)
        eval_phase(args, cfg, params, train_ckpt, workdir)
        arch_phase(18, "cnn", args, kernels, kind, smi, workdir)
        arch_phase(19, "square", args, kernels, kind, smi, workdir)
        corpus = MemoryCorpus(320, args.seed)
        f32_phase(args, cfg, params, boards, corpus, kernels, kind, smi)
        remat_phase(args, corpus, kind, smi)
        multi_device_phase(args, workdir, kind, smi)
        dp_phase(args, cfg, params, boards, train_ckpt, workdir, kind, smi)
        p384_phase(args, kernels, kind, smi, workdir)
        head_dims_phase(args, kernels, kind, smi, workdir)
        any_head_dims_phase(args, kernels, kind, smi, workdir)
        int8_modes_phase(args, cfg, params, kernels, kind, smi)
        long_legs_phase(args, kernels, kind, smi)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return report(kernels, kind, smi, started)


def report(kernels: dict, kind: str, smi: str, started: float) -> int:
    """Phase 29: the kernels line, the card and the last line."""
    import torch

    idle = [k["name"] for k in kernels.values() if k["launches"] < 1]
    require(not idle, f"kernels that no path launched: {idle}")
    if FAILED:
        raise SmokeFailure(f"{len(FAILED)} checks failed: {FAILED}")
    print(f"[29 report] {time.perf_counter() - started:.1f} s in all, the build "
          f"included", flush=True)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def codes_check(what: str, q, s, rq, rs) -> float:
    """int8 codes within one level in under 1e-3 of the elements, scales
    rtol 1e-5; returns the max |difference| of the dequantized values."""
    import torch

    diff = (q.int() - rq.int()).abs()
    flips = (diff > 0).float().mean().item()
    scale_rel = ((s - rs).abs() / rs.abs()).max().item()
    deq = (q.float() * s - rq.float() * rs).abs().max().item()
    print(f"  {what}: max level diff {diff.max().item()}, {flips:.2e} of "
          f"codes differ, scale rel diff {scale_rel:.2e}, dequantized "
          f"max |diff| {deq}", flush=True)
    require(diff.max().item() <= 1 and flips < 1e-3,
            f"{what}: codes differ by {diff.max().item()} in {flips}")
    require(scale_rel <= 1e-5 and bool(torch.isfinite(s).all()),
            f"{what}: scales differ by {scale_rel}")
    return deq


def bf16_check(what: str, out, ref) -> float:
    """bf16 outputs within one bf16 ulp; returns the max |difference|."""
    ulps = bf16_ulps(out, ref)
    err = (out.float() - ref.float()).abs().max().item()
    print(f"  {what}: max |diff| {err} ({ulps} bf16 ulp)", flush=True)
    require(ulps <= 1.0, f"{what}: {ulps} bf16 ulp from the plain version")
    return err


def ycbcr_path_phase(args, cfg, params, boards, fens_rgb, predictor_rgb,
                     kind: str, smi: str) -> None:
    """Phase 5, ycbcr420: the same boards through
    ``Predictor(mode="ycbcr420")``: planes converted on the host, RGB rebuilt
    on the card in plain PyTorch, so K1 never and K2 12 times a batch; FENs
    against the same Predictor on the plain ops; agreement with rgb mode;
    the bytes a batch sends; the conversion's device and host times;
    boards/s of both modes in turns."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from chess_vision_tpu_torch import fen_to_labels
    from chess_vision_tpu_torch.experiments.plain import forward_logits
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import preprocess as pre_ops
    from chess_vision_tpu_torch.serve import Predictor

    tag = "[5 ycbcr420]"
    depth = cfg["model"]["depth"]
    predictor = Predictor((cfg, params), batch_size=BATCH, device="cuda",
                          mode="ycbcr420")
    predictor.predict_array(boards[:BATCH])  # warm-up
    torch.cuda.synchronize()
    batches = math.ceil(args.boards / BATCH)
    reset_counts()
    fens = predictor.predict_array(boards)
    launches = {"preprocess_u8": pre_ops.LAUNCHES,
                "fused_qkv_attention": attn_ops.LAUNCHES}
    print(f"{tag} {args.boards} boards in {batches} batches: launches "
          f"{launches}", flush=True)
    require(launches == {"preprocess_u8": 0,
                         "fused_qkv_attention": depth * batches},
            f"{tag} launch counts {launches} for {batches} batches")
    with plain_ops(attn_ops, pre_ops):
        fens_plain = predictor.predict_array(boards)
        logits_p = forward_logits(predictor, boards)
    logits_k = forward_logits(predictor, boards)
    require_logits(tag, fens, fens_plain, logits_k, logits_p, SQUARES_ULPS)
    ids = [np.stack([fen_to_labels(f.split()[0]) for f in fs])
           for fs in (fens, fens_rgb)]
    h2d = {name: sum(b.numel() for b in p._slots[0].inputs)
           for name, p in (("rgb", predictor_rgb), ("ycbcr420", predictor))}
    print(f"{tag} against rgb mode (the inputs differ; not gated): square "
          f"agreement {(ids[0] == ids[1]).mean():.4f}, "
          f"{sum(a == b for a, b in zip(fens, fens_rgb))}/{args.boards} FEN "
          f"strings identical; bytes to the card a batch {h2d}", flush=True)

    # the conversion: on the card (two upsamples, the matrix, the clamp, the
    # normalize, in PyTorch), and on the host (the Predictor's pool)
    mean, std = mean_std(cfg)
    planes = pre_ops.rgb_to_ycbcr420_batch(boards[:BATCH])
    on_card = [torch.from_numpy(a).cuda() for a in planes]
    device_ms = cuda_ms(lambda: pre_ops.ycbcr420_to_normalized(
        *on_card, mean, std, torch.bfloat16), 20)
    with ThreadPoolExecutor(predictor.decode_workers) as pool:
        pre_ops.rgb_to_ycbcr420_batch(boards[:BATCH], pool)
        t0 = time.perf_counter()
        for _ in range(5):
            pre_ops.rgb_to_ycbcr420_batch(boards[:BATCH], pool)
        host_ms = (time.perf_counter() - t0) / 5 * 1e3
    t0 = time.perf_counter()
    one_core = pre_ops.rgb_to_ycbcr420_batch(boards[:BATCH])
    one_core_ms = (time.perf_counter() - t0) * 1e3
    require(all(np.array_equal(a, b) for a, b in zip(one_core, planes)),
            f"{tag} the host conversion is not deterministic")
    print(f"{tag} 4:2:0 -> normalized bf16 on the card {device_ms:.4f} ms a "
          f"batch of {BATCH}; RGB -> 4:2:0 on the host {host_ms:.1f} ms a batch "
          f"with {predictor.decode_workers} threads, {one_core_ms:.1f} ms on "
          f"one", flush=True)

    bench = np.concatenate([boards] * math.ceil(args.bench_boards / args.boards))
    bench = bench[:args.bench_boards]
    rates = {"rgb": [], "ycbcr420": []}
    for which in ("rgb", "ycbcr420", "ycbcr420", "rgb"):
        pred = predictor if which == "ycbcr420" else predictor_rgb
        t0 = time.perf_counter()
        pred.predict_array(bench)
        rates[which].append(len(bench) / (time.perf_counter() - t0))
    print(f"{tag} predict_array boards/s at batch {BATCH} ({len(bench)} boards "
          f"per run; rgb, ycbcr420, ycbcr420, rgb): {rates}; {kind}, {smi}",
          flush=True)
    del predictor, on_card
    torch.cuda.empty_cache()


def int8_kernel_phases(dev, kernels: dict) -> None:
    """Phases 6-8: each int8 kernel at the main path's shapes vs its plain
    version on the same inputs, timed with CUDA events."""
    import torch

    from chess_vision_tpu_torch.ops import _build
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import int8_matmul as mm
    from chess_vision_tpu_torch.ops import rowquant as rq

    gen = torch.Generator(device=dev).manual_seed(1)
    M = BATCH * (SIZE // 16 * SIZE // 16 + 1)

    # 6. row quant (K7 in the path; K6 is the same rows flat)
    for D, mode in ((768, "ln"), (3072, "gelu_sigmoid")):
        x = (torch.randn((M, D), device=dev, generator=gen) * 2).bfloat16()
        g = torch.rand(D, device=dev, generator=gen) + 0.5
        b = torch.randn(D, device=dev, generator=gen) * 0.1
        q, s = rq.fused_rowquant(x, mode, g, b)
        rq_, rs = rq.rowquant_plain(x, mode, g, b)
        torch.cuda.synchronize()
        err = codes_check(f"[6 K6/K7] row quant ({M}, {D}) {mode}", q, s, rq_, rs)
        ms = cuda_ms(lambda: rq.fused_rowquant(x, mode, g, b), 20)
        plain_ms = cuda_ms(lambda: rq.rowquant_plain(x, mode, g, b), 5)
        entry = kernel_entry(
            "fused_rowquant", "rowquant.cu",
            "chess_vision_tpu/ops/quant.py:159", err, ms, plain_ms,
            nbytes=3 * M * D + 4 * M + 8 * D, ops=8 * M * D, op_type="f32")
        print(f"[6 K6/K7] row quant ({M}, {D}) {mode}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms "
              f"({entry['bound_by']}): {entry['bound_ms'] / ms:.3f} of it",
              flush=True)
        if mode == "ln":
            kernels["fused_rowquant"] = entry
        del x, q, s, rq_, rs

    # K7's sigmoid GELU, four values a call with the branch-free reciprocal
    bad = mm.gelu_selftest(1 << 26, "sigmoid_mul")
    print(f"  [6 K6/K7] the row quant's sigmoid GELU, four values a call with a "
          f"branch-free division, vs the scalar GELU on {4 << 26} values: {bad} "
          f"differ in a bit", flush=True)
    require(bad == 0, f"the row quant's sigmoid GELU differs in {bad} values")

    # exact ties: with the row's abs-max at 127 each code is its value, so
    # k + 0.5 must round half to even (as jnp.round), not away from zero
    halves = torch.arange(-126, 127, device=dev, dtype=torch.float32) + 0.5
    x = torch.cat([halves.new_tensor([127.0]), halves, halves.new_zeros(2)])
    q, s = rq.fused_rowquant(x[None], "none")
    torch.cuda.synchronize()
    wrong = int((q[0].float() != torch.round(x)).sum())
    print(f"  [6 K6/K7] row quant of {halves.numel()} exact ties: {wrong} codes "
          f"not rounded half to even", flush=True)
    require(wrong == 0 and abs(s.item() - 1.0) <= 1e-6,
            f"row quant ties: {wrong} wrong, scale {s.item()}")

    # 7. int8 GEMM epilogues (K8-K10 in the path; K11-K13 the same rows)
    def operands(K, O):
        return operands_at(dev, gen, M, K, O)

    cases = (("scale_bias", 768, 2304, "chess_vision_tpu/ops/quant.py:251"),
             ("res_ln_quant", 768, 768, "chess_vision_tpu/ops/int8_matmul.py:254"),
             ("gelu_quant", 768, 3072, "chess_vision_tpu/ops/int8_matmul.py:219"),
             ("res_ln_quant", 3072, 768, "chess_vision_tpu/ops/int8_matmul.py:254"),
             ("res", 3072, 768, "chess_vision_tpu/ops/int8_matmul.py:297"))
    print(f"  [7 GEMM] {res_route_line(768)}", flush=True)
    for epi, K, O, replaces in cases:
        ops = operands(K, O)
        what = f"[7 GEMM] {epi} ({M}, {K}) -> {O}"
        # proj and fc2 share the res_ln_quant kernel: the entry keeps fc2's
        kernels[f"int8_matmul_{epi}"] = gemm_case(what, dev, gen, ops, epi,
                                                  replaces)
        if epi == "gelu_quant":
            # what K8's epilogue costs: its two sweeps by GELU, beside the
            # same product with the bias epilogue (one sweep)
            by_gelu = {gelu: cuda_ms(
                lambda: mm.int8_matmul_gelu_quant(*ops, gelu), 20)
                for gelu in mm.GELUS}
            bias_ms = cuda_ms(lambda: mm.int8_matmul_scale_bias(*ops), 20)
            print(f"  {what}: ms by GELU "
                  f"{ {k: round(v, 4) for k, v in by_gelu.items()} }; the bias "
                  f"epilogue on the same operands {bias_ms:.4f} ms", flush=True)
        del ops

    # the main loop's ragged edges: rows, columns and depth that end inside
    # a tile, a stage or a 16-row group, with every epilogue and GELU
    # (300, 128, 2304): K9 and K10 on the two-launch route (9 column tiles)
    for M_, K, O in ((300, 80, 72), (129, 16, 8), (1000, 768, 264),
                     (64, 128, 256), (4999, 3072, 776), (300, 128, 2304)):
        ops = operands_at(dev, gen, M_, K, O)
        res = torch.randn((M_, O), device=dev, generator=gen).bfloat16()
        g = torch.rand(O, device=dev, generator=gen) + 0.5
        b = torch.randn(O, device=dev, generator=gen) * 0.1
        what = f"  [7 GEMM] ragged ({M_}, {K}) -> {O}"
        print(f"{what}: {res_route_line(O, ptxas=False)}", flush=True)
        bf16_check(what + " scale_bias", mm.int8_matmul_scale_bias(*ops),
                   mm.int8_matmul_scale_bias_plain(*ops))
        bf16_check(what + " res", mm.int8_matmul_res(*ops, res),
                   mm.int8_matmul_res_plain(*ops, res))
        out = mm.int8_matmul_res_ln_quant(*ops, res, g, b)
        ref = mm.int8_matmul_res_ln_quant_plain(*ops, res, g, b)
        bf16_check(what + " res_ln_quant x'", out[0], ref[0])
        codes_check(what + " res_ln_quant", *out[1:], *ref[1:])
        for gelu in mm.GELUS:
            codes_check(f"{what} gelu_quant {gelu}",
                        *mm.int8_matmul_gelu_quant(*ops, gelu),
                        *mm.int8_matmul_gelu_quant_plain(*ops, gelu))
        del ops, res, out, ref
    for gelu in mm.GELUS:
        bad = mm.gelu_selftest(1 << 26, gelu)
        print(f"  [7 GEMM] the epilogue's {gelu} GELU, four values a call with "
              f"a branch-free division, vs the scalar GELU on {4 << 26} values: "
              f"{bad} differ in a bit", flush=True)
        require(bad == 0, f"the epilogue's {gelu} GELU differs in {bad} values")

    # 8. quantizing attention
    N = SIZE // 16 * SIZE // 16 + 1
    for B, n, H, shift in ((BATCH, N, 12, None), (BATCH, N, 12, "fixed"),
                           (3, 17, 2, "fixed"), (2, 65, 12, None),
                           (2, 65, 12, "fixed")):
        qkv = torch.randn((B, n, 3 * H * 64), device=dev,
                          generator=gen).to(torch.bfloat16)
        if shift == "fixed":  # as calibrate_attn_shifts sets it
            q, k = qkv[:8].float().reshape(min(B, 8), n, 3, H, 64)[:, :, :2].unbind(2)
            shift = torch.einsum("bqhd,bkhd->bhqk", q, k).max().item() / 8 - 40
        oq, os_ = attn_ops.fused_qkv_attention_quant(qkv, H, shift)
        rq_, rs = attn_ops.reference_attention_quant(qkv, H, shift)
        torch.cuda.synchronize()
        err = (oq.float() * os_ - rq_.float() * rs).abs().max().item()
        ms = cuda_ms(lambda: attn_ops.fused_qkv_attention_quant(qkv, H, shift), 20)
        plain_ms = cuda_ms(
            lambda: attn_ops.reference_attention_quant(qkv, H, shift), 5)
        flips = (oq != rq_).float().mean().item()
        print(f"[8 K4] attention quant {tuple(qkv.shape)} H={H} shift={shift}: "
              f"dequantized max |diff| {err} (atol {ATTN_ATOL}), {flips:.2e} "
              f"of codes differ; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
              flush=True)
        require(bool(torch.isfinite(os_).all()) and err <= ATTN_ATOL,
                f"K4 at {tuple(qkv.shape)}, shift {shift}: max |diff| {err}")
        if B == BATCH and shift is not None:
            kernels["fused_qkv_attention_quant"] = kernel_entry(
                "fused_qkv_attention_quant", "attention_quant.cu",
                "chess_vision_tpu/ops/attention.py:486", err, ms, plain_ms,
                nbytes=2 * qkv.numel() + B * n * H * 64 + 4 * B * n,
                ops=4 * B * H * n * n * 64, op_type="bf16")
        del qkv, oq, os_, rq_, rs
    lib = _build.library()
    print(f"  [8 K4] {flash_work('attention_quant_kernel', N, 64, 2 * 96 * 4)}; "
          f"clusters of 12 blocks the card holds at once: "
          f"{lib.cvt_attention_quant_max_clusters(12, 64)}", flush=True)


def gemm_case(what: str, dev, gen, ops, epi: str, replaces: str) -> dict:
    """One int8 GEMM epilogue on the operands ``ops`` (``operands_at``)
    against its plain version, as in phase 7; prints its time beside its
    share of the int8 peak, its bound and ``torch._int_mm``'s time on the same
    operands, and returns its kernels-line entry."""
    import torch

    from chess_vision_tpu_torch.ops import int8_matmul as mm

    M, K = ops[0].shape
    O = ops[2].shape[0]
    res = torch.randn((M, O), device=dev, generator=gen).bfloat16()
    g = torch.rand(O, device=dev, generator=gen) + 0.5
    b = torch.randn(O, device=dev, generator=gen) * 0.1
    kernel = getattr(mm, f"int8_matmul_{epi}")
    plain = getattr(mm, f"int8_matmul_{epi}_plain")
    extra = {"scale_bias": (), "res": (res,), "gelu_quant": ("sigmoid",),
             "res_ln_quant": (res, g, b)}[epi]
    out, ref = kernel(*ops, *extra), plain(*ops, *extra)
    torch.cuda.synchronize()
    if epi == "gelu_quant":
        err = codes_check(what, *out, *ref)
    elif epi == "res_ln_quant":
        err = max(bf16_check(what + " x'", out[0], ref[0]),
                  codes_check(what, *out[1:], *ref[1:]))
    else:
        err = bf16_check(what, out, ref)
    del out, ref
    ms = cuda_ms(lambda: kernel(*ops, *extra), 20)
    plain_ms = cuda_ms(lambda: plain(*ops, *extra), 5)
    tops = 2 * M * K * O / ms / 1e9
    # inputs: int8 x, its f32 row scales, the int8 weight, f32 column
    # scales and bias; outputs and extra inputs by epilogue (bf16 out;
    # int8 codes + row scales; the bf16 residual, and for res_ln_quant
    # also the bf16 x' and the LN's gamma and beta)
    nbytes = M * K + 4 * M + O * K + 8 * O + {
        "scale_bias": 2 * M * O, "res": 4 * M * O,
        "gelu_quant": M * O + 4 * M,
        "res_ln_quant": 5 * M * O + 4 * M + 8 * O}[epi]
    entry = kernel_entry(
        f"int8_matmul_{epi}", "int8_matmul.cu", replaces, err, ms, plain_ms,
        nbytes=nbytes, ops=2 * M * K * O, op_type="int8",
        library_ms=int_mm_ms(ops[0], ops[2], what))
    print(f"{what}: kernel {ms:.4f} ms ({tops:.0f} TOP/s, "
          f"{tops * 1e12 / PEAK_OPS['int8']:.3f} of the int8 peak), plain "
          f"{plain_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms "
          f"({entry['bound_by']}), torch._int_mm {entry['library_ms']} ms",
          flush=True)
    return entry


def operands_at(dev, gen, M: int, K: int, O: int) -> tuple:
    """Random operands of an int8 GEMM: xq (M, K), xs (M, 1), wq (O, K), ws
    and bias (O,), at the serving path's scales."""
    import torch

    ri = lambda *shape: torch.randint(  # noqa: E731
        -127, 128, shape, device=dev, generator=gen, dtype=torch.int8)
    return (ri(M, K), torch.rand((M, 1), device=dev, generator=gen) * 0.02
            + 0.002, ri(O, K),
            torch.rand(O, device=dev, generator=gen) * 0.0004 + 0.0002,
            torch.randn(O, device=dev, generator=gen) * 0.1)


def int_mm_ms(xq, wq, what: str) -> float | None:
    """The library yardstick of the int8 GEMMs: ``torch._int_mm`` on the same
    int8 operands, the product only (s32 out, no scales, no epilogue). The
    port never calls it; where this PyTorch build refuses the shapes the
    entry carries null."""
    import torch

    try:
        ms = cuda_ms(lambda: torch._int_mm(xq, wq.t()), 10)
    except RuntimeError as exc:
        print(f"  {what}: torch._int_mm does not run here "
              f"({str(exc).splitlines()[0]}): library_ms null", flush=True)
        return None
    print(f"  {what}: torch._int_mm (product only) {ms:.4f} ms", flush=True)
    return ms


def res_route_line(o: int, ptxas: bool = True) -> str:
    """K9's and K10's routes at o output columns (``mm.res_route``): K9's
    cluster and how many the card holds at once, K10's grid, a block's
    shared memory, and ptxas's registers and spills of the route kernels."""
    from chess_vision_tpu_torch.ops import int8_matmul as mm

    parts = []
    for epi in ("res_ln_quant", "res"):
        route = mm.res_route(o, epi)
        where = {"cluster": f"clusters of {route['cluster_blocks']} blocks, "
                            f"{route['count']} of them at once",
                 "tiles": f"one kernel, {route['count']} blocks, no cluster",
                 "two_launch": "the two-launch route"}
        parts.append(f"{epi} at O={o}: {where[route['route']]}, "
                     f"{route['smem_bytes']} bytes of shared memory a block")
        want = ("tiles" if epi == "res" else
                "cluster" if mm.res_cluster_blocks(o) else "two_launch")
        require(route["route"] == want
                and (route["count"] > 0 or want == "two_launch"),
                f"{epi} at O={o}: route {route}, expected {want}")
    if ptxas:
        tiles = -(-o // mm.TILE_N)  # K9's kernel takes its chunk count from them
        for kch in (tiles if tiles <= 4 else mm.CLUSTER_MAX, 0):
            parts.append(f"int8_res_kernel<{kch}>: {res_ptxas(kch)}")
    return "; ".join(parts)


def res_ptxas(kch: int) -> str:
    """ptxas's registers and spills of one instantiation of the residual
    kernel (kCh 0: K10's, else K9's), from this process's build."""
    import re

    from chess_vision_tpu_torch.ops import _build

    found = re.search(
        rf"Compiling entry function '[^']*int8_res_kernelILi{kch}E[^']*'.*?"
        rf"(\d+) bytes spill stores.*?Used (\d+) registers", _build.build_log,
        re.S)
    if not found:
        return "registers not in this build's log"
    return f"{found.group(2)} registers, {found.group(1)} bytes spilled"


def reset_counts() -> None:
    from chess_vision_tpu_torch.experiments import attn_variants as av
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import fused_block as fb
    from chess_vision_tpu_torch.ops import int8_matmul as mm
    from chess_vision_tpu_torch.ops import preprocess as pre_ops
    from chess_vision_tpu_torch.ops import rowquant as rq

    pre_ops.LAUNCHES = rq.LAUNCHES = fb.LAUNCHES = 0
    attn_ops.LAUNCHES = attn_ops.BWD_LAUNCHES = attn_ops.QUANT_LAUNCHES = 0
    attn_ops.FLAT_LAUNCHES = attn_ops.F32_LAUNCHES = attn_ops.F32_BWD_LAUNCHES = 0
    attn_ops.BWD_LONG_LAUNCHES = attn_ops.F32_BWD_LONG_LAUNCHES = 0
    for counts in (mm.LAUNCHES, av.LAUNCHES):
        for key in counts:
            counts[key] = 0


def int8_counts() -> dict:
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import fused_block as fb
    from chess_vision_tpu_torch.ops import int8_matmul as mm
    from chess_vision_tpu_torch.ops import preprocess as pre_ops
    from chess_vision_tpu_torch.ops import rowquant as rq

    return {"preprocess_u8": pre_ops.LAUNCHES,
            "fused_qkv_attention": attn_ops.LAUNCHES,
            "fused_rowquant": rq.LAUNCHES,
            "fused_qkv_attention_quant": attn_ops.QUANT_LAUNCHES,
            "fused_qkv_attention_quant_flat": attn_ops.FLAT_LAUNCHES,
            "fused_vit_block": fb.LAUNCHES,
            **{f"int8_matmul_{k}": v for k, v in mm.LAUNCHES.items()}}


def int8_want(layout: str, depth: int, batches: int, mode: str = "rgb") -> dict:
    """The launches of ``batches`` int8 forwards of ``depth`` blocks (in
    ycbcr420 mode the input is rebuilt in plain PyTorch, without K1)."""
    split = {"block": depth, "flat": depth, "fused": 1}[layout]
    return {"preprocess_u8": batches if mode == "rgb" else 0,
            "fused_qkv_attention": 0,
            "fused_rowquant": batches,
            "fused_qkv_attention_quant":
                0 if layout == "flat" else split * batches,
            "fused_qkv_attention_quant_flat":
                depth * batches if layout == "flat" else 0,
            "fused_vit_block": (depth - 1) * batches if layout == "fused" else 0,
            "int8_matmul_scale_bias": split * batches,
            "int8_matmul_gelu_quant": split * batches,
            "int8_matmul_res_ln_quant": (2 * split - 1) * batches,
            "int8_matmul_res": batches}


def path_op_checks(predictor, boards) -> dict:
    """Run one int8 forward on ``boards`` in which every kernel call is also
    computed by its plain version on the same inputs (the path goes on with
    the kernel's outputs). Returns, per op, the worst over its calls of: max
    int8 level difference, share of codes that differ, scale relative
    difference, dequantized max |difference| and bf16 ulps of bf16 outputs."""
    import torch

    from chess_vision_tpu_torch.experiments.plain import (forward_logits,
                                                          plain_versions)

    worst: dict[str, dict] = {}

    def record(name, **vals):
        slot = worst.setdefault(name, {"calls": 0})
        slot["calls"] += 1
        for key, val in vals.items():
            slot[key] = max(slot.get(key, 0.0), val)

    def codes(q, s, rq_, rs):
        diff = (q.int() - rq_.int()).abs()
        deq = (q.float() * s - rq_.float() * rs).abs()
        step = torch.maximum(s, rs)  # one quantization step of each row
        rows = (deq / step).amax(dim=-1)
        return {"levels": diff.max().item(),
                "flips": (diff > 0).float().mean().item(),
                "scale_rel": ((s - rs).abs() / rs.abs()).max().item(),
                "deq": deq.max().item(),
                "deq_levels": rows.max().item(),
                "rows_over": (rows > ATTN_LEVELS).float().mean().item(),
                "deq_bound": (ATTN_LEVELS * step).max().item(),
                "nonfinite": float(not torch.isfinite(s).all())}

    shift_arg = {"fused_qkv_attention_quant": 2,
                 "fused_qkv_attention_quant_flat": 4, "fused_vit_block": 6}

    def hook(module, name, plain):
        kernel = getattr(module, name)

        def run(*a, **kw):
            out, ref = kernel(*a, **kw), plain(*a, **kw)
            if name in shift_arg:
                at = shift_arg[name]
                shift = a[at] if len(a) > at else kw.get("softmax_shift")
            if name == "fused_vit_block":  # x', yq, ys of a whole block
                vals = block_diff(out, ref)
                if shift is None:  # as for the attention below
                    del vals["levels"], vals["flips"], vals["x_off"]
                record(name, **vals)
            elif isinstance(out, torch.Tensor):  # scale_bias, res: bf16 out
                record(name, ulps=bf16_ulps(out, ref))
            elif len(out) == 3:  # res_ln_quant: x', yq, ys
                vals = codes(*out[1:], *ref[1:])
                del vals["deq_levels"], vals["deq_bound"], vals["rows_over"]
                record(name, ulps=bf16_ulps(out[0], ref[0]), **vals)
            elif name in shift_arg:  # the quantizing attentions
                vals = codes(*out, *ref)
                if name.endswith("flat"):  # real rows only: qkv, images, n_real
                    real = lambda t: t.reshape(a[1], -1, t.shape[-1])[:, :a[2]]  # noqa: E731
                    vals = codes(*(real(t) for t in (*out, *ref)))
                if shift is None:  # the exact row max: p rounds at other
                    del vals["levels"], vals["flips"]  # values (phase 8)
                record(name, **vals)
            else:
                vals = codes(*out, *ref)
                del vals["deq_levels"], vals["deq_bound"], vals["rows_over"]
                record(name, **vals)
            return out
        return run

    with ExitStack() as stack:
        for module, name, plain in plain_versions():
            if name == "preprocess_u8":  # phase 3 holds K1 bit for bit
                continue
            stack.enter_context(
                mock.patch.object(module, name, hook(module, name, plain)))
        forward_logits(predictor, boards)
    return worst


def block_diff(out, ref) -> dict:
    """(x', yq, ys) of a whole block, kernel vs plain: the share of x' more
    than one bf16 ulp off, the largest code difference, the share of codes
    that differ, the scales' relative difference, the dequantized max
    |difference|."""
    import torch

    (x, q, s), (rx, rq_, rs) = out, ref
    xf, rf = x.float(), rx.float()
    ulp = torch.exp2(torch.floor(torch.log2(rf.abs().clamp_min(1e-30))) - 7)
    levels = (q.int() - rq_.int()).abs()
    return {"x_off": ((xf - rf).abs() > ulp).float().mean().item(),
            "x_max": (xf - rf).abs().max().item(),
            "levels": levels.max().item(),
            "flips": (levels > 0).float().mean().item(),
            "scale_rel": ((s - rs).abs() / rs.abs()).max().item(),
            "deq": (q.float() * s - rq_.float() * rs).abs().max().item(),
            "nonfinite": float(not (torch.isfinite(s).all()
                                    and torch.isfinite(xf).all()))}


def block_ok(w: dict) -> bool:
    """BLOCK_BOUNDS: see BLOCK_SHARE."""
    return (w.get("x_off", 0.0) < BLOCK_SHARE
            and w.get("flips", 0.0) < BLOCK_SHARE
            and w.get("levels", 0) <= BLOCK_LEVELS
            and w["scale_rel"] <= BLOCK_SCALE_RTOL and not w["nonfinite"])


def path_op_failures(worst: dict, tag: str = "[9 int8]",
                     exp_bf16: bool = False) -> list[str]:
    """The criteria of phases 6-8 at the path's own activations; the
    quantizing attention's codes, where its shift is the calibrated one, also
    within one level in under 1e-3 of the elements, and its dequantized
    outputs within ATTN_LEVELS steps of their row (``attn_ok``: with the
    bf16 exp, all but EXP_BF16_ROWS of the rows); the whole-block kernel
    within BLOCK_BOUNDS. Returns each op that fails them."""
    failed = []
    for name, w in worst.items():
        if name == "fused_vit_block":
            ok = block_ok(w)
        else:
            ok = ("levels" not in w or (w["levels"] <= 1 and w["flips"] < 1e-3))
            ok &= "ulps" not in w or w["ulps"] <= 1.0
            if name.startswith("fused_qkv_attention_quant"):
                ok &= attn_ok({**w, "finite": not w["nonfinite"]}, exp_bf16)
            elif "scale_rel" in w:
                ok &= w["scale_rel"] <= 1e-5 and not w["nonfinite"]
        if not ok:
            failed.append(f"{tag} {name} on the path: {w}")
    return failed


def require_path_ops(worst: dict, tag: str = "[9 int8]",
                     exp_bf16: bool = False) -> None:
    for failure in path_op_failures(worst, tag, exp_bf16):
        require(False, failure)
    for name, w in worst.items():
        if name.startswith("fused_qkv_attention_quant"):
            print(f"{tag} {name} dequantized on the path: {w['deq_levels']:.3f} "
                  f"steps of its row (bound {ATTN_LEVELS}; largest per-row "
                  f"bound {w['deq_bound']:.4g}); max |diff| {w['deq']}",
                  flush=True)


def calibration_boards(args) -> np.ndarray:
    """The 8 boards the int8 Predictors calibrate on (``path_boards``)."""
    return path_boards(args, np.random.default_rng(args.seed + 1), 8)


def build_int8_predictor(args, cfg, params, layout: str | None = None,
                         mode: str = "rgb", devices=None):
    """``Predictor(quant="int8", mode=mode)`` on the path's weights
    (``path_model``), its shifts calibrated on ``calibration_boards``, under
    CHESS_VISION_INT8_LAYOUT=layout (unset for None), warmed up; returns it
    and the set-up seconds."""
    import torch

    from chess_vision_tpu_torch.serve import Predictor

    calib = calibration_boards(args)
    env = {} if layout is None else {"CHESS_VISION_INT8_LAYOUT": layout}
    t0 = time.perf_counter()
    # the Predictor decodes its calibration files; here they are boards in
    # memory, named by index
    with mock.patch.object(Predictor, "_decode",
                           lambda self, path: calib[int(path)]), \
            mock.patch.dict(os.environ, env):
        if layout is None:
            os.environ.pop("CHESS_VISION_INT8_LAYOUT", None)
        predictor = Predictor((cfg, params), batch_size=BATCH,
                              device=None if devices else "cuda",
                              devices=devices, quant="int8", mode=mode,
                              calib_paths=[str(i) for i in range(len(calib))])
    predictor.predict_array(np.random.default_rng(args.seed + 1).integers(
        0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8))  # warm-up
    torch.cuda.synchronize()
    return predictor, time.perf_counter() - t0


def check_int8_path(tag: str, predictor, args, boards, kernels: dict,
                    count_into: tuple, planted: bool = False) -> list:
    """Drive ``predict_array`` on ``boards`` with the counts set to 0 just
    before and read just after; require the layout's launch counts, agreement
    with the same Predictor on the plain versions on the card, and every
    kernel call of one batch against its plain version. The counts of the
    kernels named in ``count_into`` go into the kernels line; ``planted``
    also reads the bounds on planted faults. Returns the FENs."""
    from chess_vision_tpu_torch.experiments.plain import (forward_logits,
                                                          plain_int8_ops)

    depth = predictor.cfg["model"]["depth"]
    layout = predictor.layout
    batches = math.ceil(args.boards / BATCH)
    reset_counts()
    fens = predictor.predict_array(boards)
    launches = int8_counts()
    want = int8_want(layout, depth, batches, predictor.mode)
    print(f"{tag} ViT-B/16 {SIZE}px int8 full width, layout {layout}, mode "
          f"{predictor.mode}, {args.boards} boards in {batches} batches of "
          f"{BATCH}: launches {launches}", flush=True)
    require(launches == want, f"{tag} launch counts {launches}, want {want}")
    for name in count_into:
        kernels[name]["launches"] = launches[name]

    with plain_int8_ops():
        fens_plain = predictor.predict_array(boards)
    require(int8_counts() == want, "the plain-ops run launched a kernel")
    logits_k = forward_logits(predictor, boards)
    with plain_int8_ops():
        logits_p = forward_logits(predictor, boards)
    require(len(fens) == args.boards, "FEN count")
    require_logits(tag, fens, fens_plain, logits_k, logits_p,
                   INT8_SQUARES_ULPS)
    if planted:
        plant_int8_faults(tag, predictor, boards[:BATCH],
                          {k: v[:BATCH] for k, v in logits_p.items()})

    # each kernel call of one batch against its plain version on the same
    # inputs, at the path's own activations (launches here are not counted)
    worst = path_op_checks(predictor, boards[:BATCH])
    print(f"{tag} each kernel call of one batch vs its plain version on "
          f"the same inputs (worst per op): {worst}", flush=True)
    calls = {name: count // batches for name, count in want.items()
             if count and name != "preprocess_u8"}
    require({k: w["calls"] for k, w in worst.items()} == calls,
            f"checked calls {worst}, want {calls}")
    require_path_ops(worst, tag)
    return fens


def plant_int8_faults(tag: str, predictor, boards, logits_p: dict) -> None:
    """Faults planted in the int8 path, one batch each. Against the plain
    path's logits, the per-row bound must fail K4's output taken from the
    next image of the batch and the last fc2 without its residual. Against
    the per-op check, it must fail K4's scales 2% too large and K4 run with
    its softmax scale 1.25x (q scaled by 1.25 before the kernel), whose
    logits reading is printed: on near-uniform random-weight attention it
    moves the logits less than the rounding the bound allows for."""
    import torch

    from chess_vision_tpu_torch.experiments.plain import forward_logits
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import int8_matmul as mm

    quant_attn, res = attn_ops.fused_qkv_attention_quant, mm.int8_matmul_res

    def rolled(*a, **kw):
        return tuple(t.roll(1, dims=0) for t in quant_attn(*a, **kw))

    def no_residual(xq, xs, wq, ws, bias, residual):
        return res(xq, xs, wq, ws, bias, torch.zeros_like(residual))

    def off_scale(*a, **kw):
        q, s = quant_attn(*a, **kw)
        return q, s * 1.02

    def hot_softmax(qkv, *a, **kw):
        d = qkv.shape[-1] // 3
        return quant_attn(torch.cat([qkv[..., :d] * 1.25, qkv[..., d:]], -1),
                          *a, **kw)

    for what, module, name, fault in (
            ("K4's output from the next image", attn_ops,
             "fused_qkv_attention_quant", rolled),
            ("the last fc2 without its residual", mm, "int8_matmul_res",
             no_residual)):
        with mock.patch.object(module, name, fault):
            logits_f = forward_logits(predictor, boards)
        require_planted(tag, what, logits_f, logits_p, INT8_SQUARES_ULPS)

    with mock.patch.object(attn_ops, "fused_qkv_attention_quant", hot_softmax):
        logits_f = forward_logits(predictor, boards)
    planted_reading(tag, "K4's softmax scale 1.25x", logits_f, logits_p,
                    INT8_SQUARES_ULPS)
    for what, fault in (("K4's scales 2% large", off_scale),
                        ("K4's softmax scale 1.25x", hot_softmax)):
        with mock.patch.object(attn_ops, "fused_qkv_attention_quant", fault):
            w = path_op_checks(predictor, boards)["fused_qkv_attention_quant"]
        fails = bool(path_op_failures({"fused_qkv_attention_quant": w}, tag))
        print(f"{tag} planted fault ({what}) against the per-op check: "
              f"{w['deq_levels']:.2f} steps of its row (bound {ATTN_LEVELS}: "
              f"{'fails' if fails else 'PASSES'}), max |diff| {w['deq']}",
              flush=True)
        require(fails, f"{tag} the planted fault ({what}) passes the per-op "
                       f"check")


def int8_path_phase(args, cfg, params, boards, fens_bf16, predictor_bf16,
                    kernels, kind, smi) -> dict:
    """Phase 9: the int8 serving path through ``Predictor(quant="int8")``,
    the default block layout. Returns what the layout phases reuse: the
    Predictor, its shifts and its FENs."""
    from chess_vision_tpu_torch import fen_to_labels
    from chess_vision_tpu_torch.experiments.plain import plain_int8_ops

    depth = cfg["model"]["depth"]
    predictor, setup_s = build_int8_predictor(args, cfg, params)
    shifts = predictor.attn_shifts
    require(len(shifts) == depth, f"{len(shifts)} calibrated shifts")
    require(predictor.layout == "block", f"layout {predictor.layout}")
    print(f"[9 int8] set-up {setup_s:.1f} s, gelu {predictor.gelu}, calibrated "
          f"shifts {[None if s is None else round(s, 3) for s in shifts]}",
          flush=True)
    fens = check_int8_path(
        "[9 int8]", predictor, args, boards, kernels,
        ("fused_rowquant", "fused_qkv_attention_quant",
         "int8_matmul_scale_bias", "int8_matmul_gelu_quant",
         "int8_matmul_res_ln_quant", "int8_matmul_res"), planted=True)
    ids_k = np.stack([fen_to_labels(f.split()[0]) for f in fens])
    ids_bf16 = np.stack([fen_to_labels(f.split()[0]) for f in fens_bf16])
    print(f"[9 int8] int8 vs bf16 (weights {args.checkpoint or 'random, '
          'near-tied logits'}; not gated): square agreement {(ids_k == ids_bf16).mean():.4f}, "
          f"{sum(a == b for a, b in zip(fens, fens_bf16))}/{args.boards} FEN "
          f"strings identical", flush=True)

    # the same in ycbcr420 mode: calibrated on the same RGB boards, so the
    # same shifts; the counts of phase 9 less K1
    ycc, setup_s = build_int8_predictor(args, cfg, params, mode="ycbcr420")
    require(ycc.attn_shifts == shifts, f"[9 int8 ycbcr420] shifts "
                                       f"{ycc.attn_shifts} differ from {shifts}")
    print(f"[9 int8 ycbcr420] set-up {setup_s:.1f} s, the shifts of phase 9",
          flush=True)
    fens_y = check_int8_path("[9 int8 ycbcr420]", ycc, args, boards, kernels, ())
    print(f"[9 int8 ycbcr420] FEN strings identical to rgb mode's (the inputs "
          f"differ; not gated): {sum(a == b for a, b in zip(fens, fens_y))}/"
          f"{args.boards}", flush=True)

    bench = np.concatenate([boards] * math.ceil(args.bench_boards / args.boards))
    bench = bench[:args.bench_boards]
    order = ("int8 kernel", "int8 plain", "int8 ycbcr420", "bf16 kernel",
             "bf16 kernel", "int8 ycbcr420", "int8 plain", "int8 kernel")
    rates = {name: [] for name in order}
    for which in order:
        pred = {"bf16 kernel": predictor_bf16, "int8 ycbcr420": ycc}.get(
            which, predictor)
        with plain_int8_ops() if which == "int8 plain" else nullcontext():
            t0 = time.perf_counter()
            pred.predict_array(bench)
            rates[which].append(len(bench) / (time.perf_counter() - t0))
    print(f"[9 int8] predict_array boards/s at batch {BATCH} ({len(bench)} "
          f"boards per run; in the order {', '.join(order)}): {rates}; "
          f"{kind}, {smi}", flush=True)
    del ycc
    if args.profile_int8:
        bench = np.concatenate(
            [boards] * math.ceil(args.profile_int8 / args.boards))
        profile_int8_batches("[9 int8]", predictor, bench[:args.profile_int8],
                             BATCH / rates["int8 kernel"][-1] * 1e3)
    return {"predictor": predictor, "shifts": shifts, "fens": fens}


def profile_int8_batches(tag: str, predictor, bench, batch_ms: float) -> None:
    """``torch.profiler`` over ``predict_array`` of an int8 Predictor (any
    layout): kernels by device time, and the device's idle share of an
    unprofiled batch of ``batch_ms``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batches = math.ceil(len(bench) / BATCH)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        predictor.predict_array(bench)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / batches
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3 / batches
    print(f"{tag} profile of {len(bench)} boards in {batches} batches: device "
          f"{device_ms:.2f} ms per batch; a batch takes {batch_ms:.2f} ms "
          f"unprofiled (idle share {1 - device_ms / batch_ms:.3f}) and "
          f"{wall_ms:.1f} ms under the profiler", flush=True)
    # the row pass runs once a batch (the first LayerNorm): K9 folds its own
    # into the cluster kernel, one launch a call
    per_batch = {name: sum(e.count for e in events
                           if e.device_type == DeviceType.CUDA and name in e.key)
                 / batches for name in ("rowquant_kernel", "int8_res_kernel")}
    print(f"{tag} kernels per batch in the profile: {per_batch}", flush=True)
    require(per_batch["rowquant_kernel"] == 1,
            f"{tag} {per_batch['rowquant_kernel']} row passes a batch")
    print(events.table(sort_by="self_device_time_total", row_limit=30,
                       max_name_column_width=60), flush=True)


def layout_path_phase(number: int, layout: str, args, cfg, params, boards,
                      int8: dict, kernels: dict):
    """Phases 14 and 15: the int8 serving path under
    CHESS_VISION_INT8_LAYOUT=flat or fused. Returns the Predictor."""
    tag = f"[{number} {layout}]"
    predictor, setup_s = build_int8_predictor(args, cfg, params, layout)
    require(predictor.layout == layout, f"{tag} layout {predictor.layout}")
    require(predictor.attn_shifts == int8["shifts"],
            f"{tag} calibrated shifts {predictor.attn_shifts} differ from "
            f"phase 9's {int8['shifts']}")
    print(f"{tag} set-up {setup_s:.1f} s, the shifts of phase 9", flush=True)
    own = {"flat": "fused_qkv_attention_quant_flat",
           "fused": "fused_vit_block"}[layout]
    fens = check_int8_path(tag, predictor, args, boards, kernels, (own,))
    same = sum(a == b for a, b in zip(fens, int8["fens"]))
    print(f"{tag} FEN strings identical to the block layout's: {same}/"
          f"{args.boards}", flush=True)
    return predictor


def layout_bench(args, boards, predictors: dict, kind: str, smi: str) -> None:
    """boards/s of the three int8 layouts' kernel paths, in turns; with
    ``--profile-int8 N``, then a profile of N boards through the flat and the
    fused layout."""
    bench = np.concatenate([boards] * math.ceil(args.bench_boards / args.boards))
    bench = bench[:args.bench_boards]
    rates = {name: [] for name in predictors}
    order = [*predictors, *reversed(predictors)]
    for name in order:
        t0 = time.perf_counter()
        predictors[name].predict_array(bench)
        rates[name].append(len(bench) / (time.perf_counter() - t0))
    print(f"[15 fused] predict_array boards/s of the int8 layouts at batch "
          f"{BATCH} ({len(bench)} boards per run; in the order "
          f"{', '.join(order)}): {rates}; {kind}, {smi}", flush=True)
    if args.profile_int8:
        bench = np.concatenate(
            [boards] * math.ceil(args.profile_int8 / args.boards))
        for name in ("flat", "fused"):
            profile_int8_batches(f"[15 {name}]", predictors[name],
                                 bench[:args.profile_int8],
                                 BATCH / rates[name][-1] * 1e3)


def layout_kernel_phases(args, dev, int8: dict, kernels: dict) -> None:
    """Phases 12 and 13: K5 and K14 at the layouts' shapes vs their plain
    versions on the same inputs, timed with CUDA events."""
    import torch

    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import fused_block as fb
    from chess_vision_tpu_torch.ops import quant
    from chess_vision_tpu_torch.ops import rowquant as rq

    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    N = SIZE // 16 * SIZE // 16 + 1
    NP = -(-N // 32) * 32

    # 12. K5
    for B, np_, n, H, shift in ((BATCH, NP, N, 12, None),
                                (BATCH, NP, N, 12, "fixed"),
                                (3, 32, 27, 2, "fixed")):
        D = H * 64
        qkv = torch.randn((B, np_, 3 * D), device=dev,
                          generator=gen).to(torch.bfloat16)
        if shift == "fixed":  # as calibrate_attn_shifts sets it
            q, k = qkv[:8, :n].float().reshape(min(B, 8), n, 3, H, 64)[:, :, :2].unbind(2)
            shift = torch.einsum("bqhd,bkhd->bhqk", q, k).max().item() / 8 - 40
        flat = qkv.reshape(B * np_, 3 * D)
        real = lambda t: t.reshape(B, np_, -1)[:, :n]  # noqa: E731
        run = lambda: attn_ops.fused_qkv_attention_quant_flat(  # noqa: E731
            flat, B, n, H, shift)
        oq, os_ = run()
        rq_, rs = attn_ops.reference_attention_quant_flat(flat, B, n, H, shift)
        kq, ks = attn_ops.fused_qkv_attention_quant(qkv[:, :n].contiguous(), H,
                                                    shift)
        loud = qkv.clone()
        loud[:, n:, D:] = 1e4  # the padded keys and values
        lq, ls = attn_ops.fused_qkv_attention_quant_flat(
            loud.reshape(B * np_, 3 * D), B, n, H, shift)
        torch.cuda.synchronize()
        err = real(oq.float() * os_ - rq_.float() * rs).abs().max().item()
        k4_diff = int((real(oq) != kq).sum()) + int((real(os_) != ks).sum())
        loud_diff = (int((real(lq) != real(oq)).sum())
                     + int((real(ls) != real(os_)).sum()))
        finite = bool(torch.isfinite(os_).all())  # padded query rows too
        del loud, lq, ls, kq, ks
        ms = cuda_ms(run, 20)
        plain_ms = cuda_ms(lambda: attn_ops.reference_attention_quant_flat(
            flat, B, n, H, shift), 5)
        entry = kernel_entry(
            "fused_qkv_attention_quant_flat", "attention_quant.cu",
            "chess_vision_tpu/ops/attention.py:772", err, ms, plain_ms,
            nbytes=2 * qkv.numel() + B * np_ * D + 4 * B * np_,
            ops=4 * B * H * np_ * n * 64, op_type="bf16")
        print(f"[12 K5] flat attention quant ({B * np_}, {3 * D}) images {B} "
              f"n_real {n} H={H} shift={shift}: real rows dequantized max "
              f"|diff| {err} (atol {ATTN_ATOL}); {k4_diff} codes and scales "
              f"differ from K4 on the unpadded values; {loud_diff} differ with "
              f"the padded keys at 1e4; scales finite {finite}; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})", flush=True)
        require(finite and err <= ATTN_ATOL,
                f"K5 at {tuple(flat.shape)}, shift {shift}: max |diff| {err}")
        require(k4_diff == 0, f"K5's real rows differ from K4 in {k4_diff}")
        require(loud_diff == 0, f"padded keys reached {loud_diff} real values")
        if B == BATCH and shift is not None:
            kernels["fused_qkv_attention_quant_flat"] = entry
        del qkv, flat, oq, os_, rq_, rs

    # 12. K11-K13: the flat layout's GEMMs at its own rows (BATCH images of NP)
    print(f"  [12 K11-K13] {res_route_line(768)}", flush=True)
    for epi, K, O, replaces in (
            ("gelu_quant", 768, 3072, "chess_vision_tpu/ops/int8_matmul.py:395"),
            ("res_ln_quant", 768, 768, "chess_vision_tpu/ops/int8_matmul.py:426"),
            ("res_ln_quant", 3072, 768, "chess_vision_tpu/ops/int8_matmul.py:426"),
            ("res", 3072, 768, "chess_vision_tpu/ops/int8_matmul.py:465")):
        ops = operands_at(dev, gen, BATCH * NP, K, O)
        gemm_case(f"[12 K11-K13] flat {epi} ({BATCH * NP}, {K}) -> {O}", dev, gen,
                  ops, epi, replaces)
        del ops

    # 13. K14: block 0 of the served model at the path's shape, and a small
    # block of random int8 weights
    def small_block(D, O1):
        ri = lambda *shape: torch.randint(  # noqa: E731
            -127, 128, shape, device=dev, generator=gen, dtype=torch.int8)
        dense = lambda k, o: {  # noqa: E731
            "wq": ri(o, k),
            "scale": torch.rand(o, device=dev, generator=gen) * 4e-4 + 2e-4,
            "bias": torch.randn(o, device=dev, generator=gen) * 0.1}
        norm = lambda: {  # noqa: E731
            "scale": torch.rand(D, device=dev, generator=gen) + 0.5,
            "bias": torch.randn(D, device=dev, generator=gen) * 0.1}
        return {"norm1": norm(), "norm2": norm(), "qkv": dense(D, 3 * D),
                "proj": dense(D, D), "fc1": dense(D, O1), "fc2": dense(O1, D)}

    blocks = int8["predictor"].pack["blocks"]
    # layer 0's calibrated shift; 0.0 (the random model's logits stay within
    # a few units) should calibration have left that layer to the row max
    shift0 = int8["shifts"][0] if int8["shifts"][0] is not None else 0.0
    cases = ((BATCH, N, 12, blocks[0], blocks[1]["norm1"], shift0),
             (3, 17, 2, small_block(128, 256), small_block(128, 256)["norm1"],
              1.0))
    for B, n, H, q, nxt, shift in cases:
        D = H * 64
        O1 = q["fc1"]["wq"].shape[0]
        x = (torch.randn((B, n, D), device=dev, generator=gen) * 0.5).bfloat16()
        xq, xs = rq.fused_rowquant(x, "ln", q["norm1"]["scale"],
                                   q["norm1"]["bias"])
        run = lambda: fb.fused_vit_block(xq, xs, x, q, nxt, H, shift)  # noqa: E731
        split = lambda: quant.block_int8(x, xq, xs, q, nxt, H, shift)  # noqa: E731
        out, again, chain = run(), run(), split()
        ref = fb.fused_vit_block_plain(xq, xs, x, q, nxt, H, shift)
        bad = block_plain_unrounded_residual(xq, xs, x, q, nxt, H, shift)
        torch.cuda.synchronize()
        same = all(bool((a == b).all()) for a, b in zip(out, again))
        as_chain = all(bool((a == b).all()) for a, b in zip(out, chain))
        diff, planted = block_diff(out, ref), block_diff(out, bad)
        del again, chain, ref, bad
        times = {"fused": [], "split": []}
        for which in ("fused", "split", "split", "fused"):
            times[which].append(cuda_ms(run if which == "fused" else split, 10))
        ms = min(times["fused"])
        plain_ms = cuda_ms(lambda: fb.fused_vit_block_plain(
            xq, xs, x, q, nxt, H, shift), 3)
        stage_ns = torch.zeros(len(fb.STAGES) + 1, dtype=torch.int64, device=dev)
        fb.fused_vit_block(xq, xs, x, q, nxt, H, shift, stage_ns=stage_ns)
        torch.cuda.synchronize()
        stages = dict(zip(fb.STAGES, (stage_ns.diff().cpu() / 1e6).tolist()))
        print(f"[13 K14] stages of one launch, ms by the card's clock (the last "
              f"is block 0's share): {stages}", flush=True)
        M = B * n
        entry = kernel_entry(
            "fused_vit_block", "fused_block.cu",
            "chess_vision_tpu/ops/fused_block.py:202", diff["deq"], ms, plain_ms,
            # in: int8 x + row scales, bf16 residual, the four int8 weights
            # with column scales and biases, two LNs; out: bf16 x', int8
            # codes + row scales
            nbytes=(M * D + 4 * M + 2 * M * D + D * (4 * D + 2 * O1)
                    + 8 * (4 * D + O1 + D) + 16 * D + 2 * M * D + M * D + 4 * M),
            ops={"int8": 2 * M * D * (4 * D + 2 * O1),
                 "bf16": 4 * B * H * n * n * 64})
        print(f"[13 K14] whole block ({B}, {n}, {D}) H={H} O1={O1} shift="
              f"{shift}: two launches bit-identical {same}; bit-identical to "
              f"the split chain {as_chain}; vs plain {diff} (bounds: shares "
              f"< {BLOCK_SHARE}, levels <= {BLOCK_LEVELS}, scales rtol "
              f"{BLOCK_SCALE_RTOL}); planted fault (residual not rounded "
              f"before the LN) {planted}; kernel ms {times['fused']}, split "
              f"chain of 5 launches ms {times['split']} (in the order fused, "
              f"split, split, fused), plain {plain_ms:.4f} ms, bound "
              f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})", flush=True)
        require(same, "K14 is not deterministic")
        require(as_chain, "K14 differs from the chain of split kernels")
        require(block_ok(diff), f"K14 at {(B, n, D)} vs plain: {diff}")
        require(not block_ok(planted), f"the planted fault passes: {planted}")
        if B == BATCH:
            kernels["fused_vit_block"] = entry
        del x, xq, xs, out
    torch.cuda.empty_cache()


def block_plain_unrounded_residual(xq, xs, res, q, next_ln, num_heads, shift):
    """``fused_vit_block_plain`` with a planted fault: LN2 reads the f32
    residual sum instead of its bf16 rounding."""
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import int8_matmul as mm
    from chess_vision_tpu_torch.ops import rowquant as rq

    qkv = mm.int8_matmul_scale_bias_plain(
        xq, xs, q["qkv"]["wq"], q["qkv"]["scale"], q["qkv"]["bias"])
    aq, as_ = attn_ops.reference_attention_quant(qkv, num_heads, shift)
    x1 = res.float() + mm._rescaled(aq, as_, q["proj"]["wq"],
                                    q["proj"]["scale"], q["proj"]["bias"])
    hq, hs = rq.rowquant_plain(x1, "ln", q["norm2"]["scale"],
                               q["norm2"]["bias"])  # the fault: x1 is f32
    gq, gs = mm.int8_matmul_gelu_quant_plain(
        hq, hs, q["fc1"]["wq"], q["fc1"]["scale"], q["fc1"]["bias"], "sigmoid")
    return mm.int8_matmul_res_ln_quant_plain(
        gq, gs, q["fc2"]["wq"], q["fc2"]["scale"], q["fc2"]["bias"],
        x1.to(res.dtype), next_ln["scale"], next_ln["bias"])


def variant_sweep_phase(args, dev, kernels: dict) -> None:
    """Phase 16: the attention-variant sweep and each variant's kernel vs
    its plain version."""
    import torch

    from chess_vision_tpu_torch.experiments import attn_variants as av
    from chess_vision_tpu_torch.ops import rowquant as rq

    reset_counts()
    times = av.sweep(BATCH)
    launches = dict(av.LAUNCHES)
    row_passes = rq.LAUNCHES
    print(f"[16 K15] sweep at batch {BATCH}: launches {launches}, row-quant "
          f"launches {row_passes}", flush=True)
    require(list(times) == list(av.VARIANTS), f"sweep ran {list(times)}")
    require(all(count == 17 for count in launches.values()),
            f"sweep launch counts {launches}, want 1 + 16 each")
    require(row_passes == 0, f"the sweep launched the row quant {row_passes} "
            "times")

    gen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    N, H, Dh = SIZE // 16 * SIZE // 16 + 1, 12, 64
    D = H * Dh
    qkv = torch.randn((BATCH, N, 3 * D), device=dev,
                      generator=gen).to(torch.bfloat16)
    traced = traced_kernels(
        "from chess_vision_tpu_torch.experiments import attn_variants as av\n"
        f"qkv = torch.randn(({BATCH}, {N}, {3 * D}), device='cuda')"
        ".to(torch.bfloat16)\n"
        "for name in av.VARIANTS:\n"
        f"    calls[name] = (lambda k: lambda: k(qkv))(av.make_variant(name, {H}, "
        f"{N}, {D}))\n")
    for name in av.VARIANTS:
        kernel = av.make_variant(name, H, N, D)
        plain = av.variant_plain(name, H, N, D)
        (oq, os_), (rq_, rs) = kernel(qkv), plain(qkv)
        two = av.make_variant(name, H, N, D, bb=2)(qkv)
        torch.cuda.synchronize()
        err = (oq.float() * os_ - rq_.float() * rs).abs().max().item()
        flips = (oq != rq_).float().mean().item()
        bb_same = bool((two[0] == oq).all() and (two[1] == os_).all())
        finite = bool(torch.isfinite(os_).all())
        del two, rq_, rs
        ms = cuda_ms(lambda: kernel(qkv), 20)
        plain_ms = cuda_ms(lambda: plain(qkv), 3)
        device_kernels = traced.get(name, [])
        atol = VARIANT_ATOL.get(name, ATTN_ATOL)
        entry = kernels[f"attn_variant_{name}"] = kernel_entry(
            f"attn_variant_{name}", "attention_variants.cu",
            "experiments/attn_variants.py:43", err, ms, plain_ms,
            nbytes=2 * qkv.numel() + BATCH * N * D + 4 * BATCH * N,
            ops=4 * BATCH * H * N * N * Dh, op_type="bf16")
        entry["launches"] = launches[name]
        print(f"[16 K15] variant {name} {tuple(qkv.shape)}: dequantized max "
              f"|diff| {err} (atol {atol}), {flips:.2e} of codes differ, bb=2 "
              f"bit-identical {bb_same}; kernel {ms:.4f} ms (earlier design "
              f"{K15_EARLIER_MS[name]:.4f}), plain {plain_ms:.4f} ms, bound "
              f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}); sweep "
              f"{times[name]:.4f} ms/batch; device kernels of one call "
              f"{device_kernels}; "
              f"{ptxas_counts('attention_variant_kernel', Dh, av.VARIANTS[name])}",
              flush=True)
        require(finite and err <= atol, f"K15 {name}: max |diff| {err}")
        require(bb_same, f"K15 {name}: bb=2 differs from bb=1")
        require(len(device_kernels) == 1
                and "attention_variant_kernel" in device_kernels[0],
                f"K15 {name}: one call ran the device kernels {device_kernels}")
        del oq, os_
    del qkv
    torch.cuda.empty_cache()


@contextmanager
def plain_ops(attn_ops, pre_ops):
    """Route the model's attention and the Predictor's preprocess through the
    plain PyTorch versions, on the card."""
    with mock.patch.object(attn_ops, "fused_qkv_attention",
                           attn_ops.reference_attention), \
            mock.patch.object(pre_ops, "preprocess_u8",
                              pre_ops.preprocess_u8_plain):
        yield


def sdpa_ms(qkv, g, H: int) -> tuple[float, float]:
    """The library yardstick of K2 and K3, which the port never calls:
    ``scaled_dot_product_attention`` forward, and its backward alone, on
    contiguous (B, H, N, Dh) copies of the same q, k, v and cotangent (the
    permute copies that route would also need are not counted)."""
    import torch
    import torch.nn.functional as F

    B, N, C3 = qkv.shape
    Dh = C3 // 3 // H
    q, k, v = (t.permute(0, 2, 1, 3).contiguous().requires_grad_()
               for t in qkv.reshape(B, N, 3, H, Dh).unbind(2))
    go = g.reshape(B, N, H, Dh).permute(0, 2, 1, 3).contiguous()
    with torch.no_grad():
        fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
    out = F.scaled_dot_product_attention(q, k, v)
    bwd = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), go,
                                              retain_graph=True), 20)
    return fwd, bwd


def attention_bwd_phase(args, dev, kernels: dict) -> None:
    """Phase 10: K3 vs ``reference_attention_bwd``, and the library
    yardsticks of K2 and K3."""
    import torch

    from chess_vision_tpu_torch.ops import attention as attn_ops

    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    N = SIZE // 16 * SIZE // 16 + 1
    # 289 and 577 tokens (a 384 px ViT) take the long route
    odd = [(2, n, 2, Dh) for n in (17, 64, 65, 257, 264, 289, 577)
           for Dh in (16, 32, 64)]
    long_n = (384 // 16) ** 2 + 1
    for B, n, H, Dh in ((BATCH, N, 12, 64), (TRAIN_BATCH, N, 12, 64),
                        (3, 17, 1, 32), *odd, (TRAIN_BATCH, long_n, 12, 64)):
        D = H * Dh
        qkv = torch.randn((B, n, 3 * D), device=dev, generator=gen).bfloat16()
        g = torch.randn((B, n, D), device=dev, generator=gen).bfloat16()
        out = attn_ops.fused_qkv_attention_bwd(qkv, g, H)
        again = attn_ops.fused_qkv_attention_bwd(qkv, g, H)
        ref = attn_ops.reference_attention_bwd(qkv, g, H)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs().reshape(B, n, 3, D)
        errs = {name: diff[:, :, i].max().item()
                for i, name in enumerate(("dq", "dk", "dv"))}
        finite = bool(torch.isfinite(out).all())
        same = bool((out == again).all())
        # planted fault: dK made from the unscaled dS
        bad_dk = ref[..., D:2 * D].float() * math.sqrt(Dh)
        planted = (out[..., D:2 * D].float() - bad_dk).abs().max().item()
        del diff, bad_dk, again
        ms = cuda_ms(lambda: attn_ops.fused_qkv_attention_bwd(qkv, g, H), 20)
        plain_ms = cuda_ms(
            lambda: attn_ops.reference_attention_bwd(qkv, g, H), 3)
        route = attn_ops.bwd_route(n)
        work = (k3_work(n, Dh) if route == "short" else
                f"the long route, (clusters, CTAs, warps) {attn_ops.long_plan(n)}"
                f" a head; {ptxas_counts('attention_bwd_cluster_kernel', Dh, 0)}")
        print(f"[10 K3] attention backward {tuple(qkv.shape)} H={H}: max |diff| "
              f"{errs} (atol {K3_ATOL}), planted unscaled dK {planted}, two "
              f"launches bit-identical {same}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; {work}", flush=True)
        require(finite and max(errs.values()) <= K3_ATOL,
                f"K3 at {tuple(qkv.shape)}: {errs}, finite {finite}")
        require(planted > K3_ATOL, f"the planted fault passes: {planted}")
        require(same, "K3 is not deterministic")
        if B >= TRAIN_BATCH:
            fwd_ms, bwd_ms = sdpa_ms(qkv, g, H)
            print(f"[10 K3] scaled_dot_product_attention on the same values: "
                  f"forward {fwd_ms:.4f} ms, backward {bwd_ms:.4f} ms",
                  flush=True)
        if B == BATCH or n == long_n:
            if B == BATCH:
                kernels["fused_qkv_attention"]["library_ms"] = fwd_ms
            name = ("fused_qkv_attention_bwd" if route == "short"
                    else "fused_qkv_attention_bwd_long")
            kernels[name] = kernel_entry(
                name, "attention_bwd.cu" if route == "short"
                else "attention_bwd_cluster.cu",
                "chess_vision_tpu/ops/attention.py:623", max(errs.values()),
                ms, plain_ms, nbytes=2 * (2 * qkv.numel() + g.numel()),
                ops=10 * B * H * n * n * Dh, op_type="bf16", library_ms=bwd_ms)
        del qkv, g, out, ref
    torch.cuda.empty_cache()


def k3_work(n: int, head_dim: int) -> str:
    """What K3 executes per (image, head) at n tokens: its 7 products (S and
    dP in both sweeps, dQ, dK, dV) over 16-row and 16-key groups, beside the 5
    products on n x n the function needs; ptxas's registers for this head dim
    (from this process's build, if it built) and the block's shared memory."""
    import re

    from chess_vision_tpu_torch.ops import _build

    padded = -(-n // 16) * 16
    done = 7 * 2 * padded * padded * head_dim
    needed = 5 * 2 * n * n * head_dim
    smem = 2 * padded * (4 * (head_dim + 8) + 2 * 40)
    found = re.search(
        rf"attention_bwd_kernelILi{head_dim}E.*?Used (\d+) registers",
        _build.build_log, re.S)
    regs = f"{found.group(1)} registers" if found else "registers not in this build's log"
    return (f"7 products on {padded} x {padded}: {done / 1e6:.2f} MFLOP per head "
            f"for {needed / 1e6:.2f} needed ({done / needed:.2f}x); {regs}, "
            f"{smem} bytes of shared memory per block")


def ptxas_counts(kernel: str, head_dim: int, variant: int | None = None,
                 flags: tuple = ()) -> str:
    """ptxas's registers and spills of one instantiation of a kernel (K15's
    of one variant, K3's long and f32 backward of one mode, the int8 legs'
    of their bool template arguments ``flags``), from this process's build
    (empty when an up-to-date library was reused)."""
    import re

    from chess_vision_tpu_torch.ops import _build

    args = f"ILi{head_dim}E" if variant is None else f"ILi{head_dim}ELi{variant}E"
    args += "".join(f"Lb{int(f)}E" for f in flags)
    found = re.search(
        rf"Compiling entry function '[^']*{kernel}{args}[^']*'.*?"
        rf"(\d+) bytes spill stores.*?Used (\d+) registers", _build.build_log,
        re.S)
    if not found:
        return "registers not in this build's log"
    return f"{found.group(2)} registers, {found.group(1)} bytes spilled"


# The device kernels of one call each of some functions, traced by
# torch.profiler in a process of its own: late in this long process the
# profiler's sessions come back empty now and then, three in a row, for
# calls whose kernels ran (K15 noshift in phase 16, an f32 backward in phase
# 20). `setup` (Python source) puts the functions in `calls`.
_TRACE = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
calls = {}
exec(sys.argv[1])
found = {}
for name, call in calls.items():
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    found[name] = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "memset" not in e.name.lower()
                   and "memcpy" not in e.name.lower()]
print(json.dumps(found))
"""


def traced_kernels(setup: str) -> dict:
    """name -> the device kernels one call of ``calls[name]`` runs, traced in
    a child process on this checkout's library (already built)."""
    root = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-c", _TRACE, setup], cwd=root,
                       capture_output=True, text=True, timeout=600)
    require(r.returncode == 0, f"kernel trace exit {r.returncode}: "
                               f"{r.stderr[-2000:]}")
    return json.loads(r.stdout.splitlines()[-1]) if r.returncode == 0 else {}


def flash_work(kernel: str, n: int, head_dim: int, extra_smem: int = 0) -> str:
    """What the forward loop (csrc/attention_loop.cuh) executes at n tokens:
    16-row and 16-key edges, row chunks of 3 warps (96 rows), a 2-stage K/V
    ring; ptxas's counts and the block's shared memory (the ring and the Q
    rows, plus ``extra_smem`` bytes of the kernel's own)."""
    padded = -(-n // 16) * 16
    blocks = -(-n // 16)
    chunks = -(-blocks // 6)
    smem = 2 * (2 * 2 * 64 + 96) * (head_dim + 8) + extra_smem
    return (f"{padded} x {padded} scores per head ({padded * padded / n / n:.2f}x"
            f" the needed), {chunks} row chunks per head; "
            f"{ptxas_counts(kernel, head_dim)}, {smem} bytes of shared memory "
            f"per block")


class MemoryCorpus:
    """An in-memory dataset with the interface of ``data.ChessDataset``:
    random uint8 boards, labels from random legal-looking FENs."""

    def __init__(self, count: int, seed: int, size: int = SIZE):
        from chess_vision_tpu_torch.fen import parse_full_fen

        rng = np.random.default_rng(seed)
        self.input_size = size
        self.boards = rng.integers(0, 256, (count, SIZE, SIZE, 3), dtype=np.uint8)
        if size != SIZE:  # resized as data.ChessDataset resizes to input_size
            from PIL import Image

            self.boards = np.stack([np.asarray(Image.fromarray(b).resize(
                (size, size), Image.BILINEAR)) for b in self.boards])
        self.samples = [{"filename": f"{i:06d}.png", "fen": random_fen(rng),
                         "legal": "1"} for i in range(count)]
        self._parse = parse_full_fen

    def __len__(self) -> int:
        return len(self.samples)

    def labels_for(self, idx: int) -> dict:
        labels = self._parse(self.samples[idx]["fen"])
        labels["legal"] = np.ones(1, np.float32)
        return labels

    def load_image(self, idx: int) -> np.ndarray:
        return self.boards[idx]

    def load_planes(self, idx: int):
        from chess_vision_tpu_torch.ops.preprocess import rgb_to_ycbcr420

        return rgb_to_ycbcr420(self.boards[idx])


def random_fen(rng) -> str:
    """Both kings, up to 14 other pieces on random squares, a side to move
    and castling rights."""
    squares = ["."] * 64
    where = rng.permutation(64)
    pieces = ["K", "k"] + list(rng.choice(list("PPPPNBRQppppnbrq"),
                                          size=int(rng.integers(2, 15))))
    for sq, piece in zip(where, pieces):
        squares[sq] = piece
    rows = []
    for r in range(8):
        row, gap = "", 0
        for c in squares[8 * r:8 * r + 8]:
            if c == ".":
                gap += 1
                continue
            row += (str(gap) if gap else "") + c
            gap = 0
        rows.append(row + (str(gap) if gap else ""))
    rights = "".join(c for c in "KQkq" if rng.random() < 0.5) or "-"
    return f"{'/'.join(rows)} {'wb'[int(rng.integers(2))]} {rights} - 0 1"


def train_config(save_dir: str, **model_overrides) -> dict:
    """The values of ``configs/vit.yaml`` written out (no pretrained weights,
    no OOD set), for the in-memory corpus: 256 train boards, 64 held out."""
    model = {"arch": "vit", "name": "vit_base_patch16_224.augreg_in21k",
             "pretrained": False, "freeze_backbone": False, "input_size": SIZE,
             "head_dropout": 0.1, "drop_path_rate": 0.1, "embed_dim": 768,
             "depth": 12, "num_heads": 12, "mlp_ratio": 4.0}
    model.update(model_overrides)
    return {
        "data": {"val_split": 0.2, "num_workers": 4, "max_samples": None},
        "model": model,
        "training": {"epochs": 2, "batch_size": TRAIN_BATCH, "lr": 1.0e-4,
                     "weight_decay": 0.01, "grad_clip_norm": 1.0,
                     "mixed_precision": True, "label_smoothing": 0.1,
                     "use_class_weights": True, "turn_loss_weight": 1.0,
                     "castling_loss_weight": 1.0},
        "scheduler": {"type": "cosine", "warmup_epochs": 1},
        "checkpointing": {"save_dir": save_dir, "save_best": True,
                          "early_stopping_patience": 3},
        "logging": {"tensorboard_dir": save_dir + "/runs"},
    }


@contextmanager
def plain_attention():
    """Route the model's attention, forward and backward, through the plain
    PyTorch versions on the card."""
    from chess_vision_tpu_torch.ops import attention as attn_ops

    with mock.patch.object(attn_ops, "fused_qkv_attention_fwd",
                           attn_ops.reference_attention), \
            mock.patch.object(attn_ops, "fused_qkv_attention_bwd",
                              attn_ops.reference_attention_bwd):
        yield


def attention_counts() -> tuple[int, int]:
    from chess_vision_tpu_torch.ops import attention as attn_ops

    return attn_ops.LAUNCHES, attn_ops.BWD_LAUNCHES


def make_trainer(cfg: dict, corpus, seed: int, steps_per_epoch: int = 4,
                 batch: int = TRAIN_BATCH):
    """A fresh model, train state and steps from ``cfg``, with the pieces the
    trainer's ``train`` uses, and device batches of the corpus."""
    import torch

    from chess_vision_tpu_torch.config import get_data_config
    from chess_vision_tpu_torch.data import BatchLoader
    from chess_vision_tpu_torch.models import build_model, init_weights
    from chess_vision_tpu_torch.train.loop import BatchStager, make_steps
    from chess_vision_tpu_torch.train.state import (
        compute_class_weights,
        create_train_state,
    )

    dev = torch.device("cuda")
    model = init_weights(build_model(cfg), seed=seed).to(dev)
    state = create_train_state(cfg, model, steps_per_epoch)
    data_cfg = get_data_config(cfg["model"]["name"])
    train_step, eval_step = make_steps(
        state, cfg, compute_class_weights(corpus.samples), data_cfg["mean"],
        data_cfg["std"], seed=seed)
    loader = BatchLoader(corpus, np.arange(len(corpus)), batch,
                         num_workers=4, drop_remainder=True)
    stager = BatchStager(dev, slots=len(loader))
    batches = [stager(b) for b in loader]
    return state, train_step, eval_step, batches


def train_path_phase(args, kernels: dict, kind: str, smi: str,
                     workdir: str) -> str:
    """Phase 11: the training path at full width. Returns the path of its
    ``latest.ckpt``, moved into ``workdir``."""
    import torch

    from chess_vision_tpu_torch.augment import draw_params
    from chess_vision_tpu_torch.models import resolve_remat
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.train.__main__ import train
    from chess_vision_tpu_torch.utils.checkpoint import load_checkpoint

    dev = torch.device("cuda")
    depth = 12
    corpus = MemoryCorpus(320, args.seed)
    total_gib = torch.cuda.get_device_properties(dev).total_memory / 2**30
    print(f"[11 train] resolve_remat(batch {TRAIN_BATCH}) on {total_gib:.1f} GiB "
          f"-> {resolve_remat(TRAIN_BATCH, dev)}; it turns to full remat at "
          f"batch {next(b for b in range(64, 1 << 16, 64) if resolve_remat(b, dev))}",
          flush=True)

    # the main path: the function the CLI calls, 2 epochs of 4 steps
    save_dir = os.path.join(workdir, "train")
    kept = os.path.join(workdir, "ckpt", "latest.ckpt")
    per_step = []

    def on_step(step_kind, sums):
        per_step.append((step_kind, *attention_counts(),
                         sums.get("step_loss", sums["loss_sum"])))
        attn_ops.LAUNCHES = attn_ops.BWD_LAUNCHES = 0

    try:
        cfg = train_config(save_dir)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = train(cfg, corpus, seed=args.seed, device="cuda",
                       on_step=on_step)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        os.makedirs(os.path.dirname(kept))
        shutil.move(os.path.join(save_dir, "latest.ckpt"), kept)
        ckpt = load_checkpoint(kept)
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    history = result["history"]
    losses = torch.stack([s[3] for s in per_step if s[0] == "train"]).tolist()
    launches = {"train": sorted({s[1:3] for s in per_step if s[0] == "train"}),
                "eval": sorted({s[1:3] for s in per_step if s[0] == "eval"})}
    n_train = sum(s[0] == "train" for s in per_step)
    n_eval = sum(s[0] == "eval" for s in per_step)
    print(f"[11 train] ViT-B/16 {SIZE}px bf16 full width, batch {TRAIN_BATCH}, "
          f"remat {cfg['model']['remat']}: {n_train} train steps and {n_eval} "
          f"eval steps in {train_s:.1f} s; (K2, K3) launches per step "
          f"{launches}; step losses {[round(x, 4) for x in losses]}; epoch "
          f"train losses {[h['train']['loss'] for h in history]}, val "
          f"{[h['val']['loss'] for h in history]}; train img/s by epoch "
          f"{[round(h['train_img_per_s'], 1) for h in history]} (loader and "
          f"first-step warm-up included); peak device memory {peak_gib:.2f} "
          f"GiB", flush=True)
    require(n_train == 8 and n_eval == 2, f"{n_train} train, {n_eval} eval steps")
    require(launches == {"train": [(depth, depth)], "eval": [(depth, 0)]},
            f"attention launches per step {launches}")
    require(all(math.isfinite(x) for x in losses), f"step losses {losses}")
    require(all(math.isfinite(h["val"]["loss"]) for h in history), "val loss")
    require(history[-1]["train"]["loss"] < history[0]["train"]["loss"],
            "the mean train loss did not fall")
    kernels["fused_qkv_attention"]["train_launches"] = depth * (n_train + n_eval)
    kernels["fused_qkv_attention_bwd"]["launches"] = depth * n_train
    require(ckpt["step"] == n_train and ckpt["epoch"] == 1
            and ckpt["params"]["backbone"]["block11"]["mlp"]["fc1"]["kernel"].shape
            == (768, 3072)
            and ckpt["opt_state"]["1"]["0"]["mu"]["type_head"]["kernel"].shape
            == (768, 7), "the checkpoint read back")
    print(f"[11 train] latest.ckpt written with msgpack and read back: step "
          f"{ckpt['step']}, epoch {ckpt['epoch']}", flush=True)
    del result, ckpt
    device_cache_runs(args, corpus, workdir, kind, smi)

    # one remat step: the forward of every block runs again in the backward
    state, train_step, _, batches = make_trainer(
        train_config("", remat=True), corpus, args.seed)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    train_step(batches[0])
    torch.cuda.synchronize()
    remat_counts = attention_counts()
    remat_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[11 train] one step with remat: (K2, K3) launches {remat_counts}, "
          f"peak device memory {remat_peak:.2f} GiB", flush=True)
    require(remat_counts == (2 * depth, depth), f"remat launches {remat_counts}")
    del state, train_step, batches
    torch.cuda.empty_cache()

    # kernel path vs plain path: one step from the same state, dropout and
    # drop path off, the same augmentation draws
    quiet = train_config("", head_dropout=0.0, drop_path_rate=0.0, remat=False)
    quiet["scheduler"]["warmup_epochs"] = 0  # lr(0) is the base rate
    state_k, step_k, _, batches = make_trainer(quiet, corpus, args.seed)
    state_p, step_p, _, _ = make_trainer(quiet, corpus, args.seed)
    before = {n: p.detach().clone() for n, p in state_k.model.named_parameters()}
    aug = draw_params(TRAIN_BATCH, torch.Generator(device=dev).manual_seed(args.seed))
    grads_k, loss_k = step_with_grads(state_k, step_k, batches[0], aug)
    with plain_attention():
        counts = attention_counts()
        grads_p, loss_p = step_with_grads(state_p, step_p, batches[0], aug)
        require(attention_counts() == counts, "the plain step launched a kernel")
    rel = {n: ((grads_k[n] - grads_p[n]).abs().max()
               / grads_p[n].abs().max().clamp_min(1e-30)).item() for n in grads_p}
    worst = max(rel, key=rel.get)
    moved = sum(bool((p != before[n]).any())
                for n, p in state_k.model.named_parameters())
    print(f"[11 train] one step, kernels vs plain attention on the card: loss "
          f"{loss_k} vs {loss_p} (atol {TRAIN_LOSS_ATOL}); per-tensor max "
          f"|grad diff| / max |grad|: worst {rel[worst]:.4f} at {worst}, "
          f"median {float(np.median(list(rel.values()))):.4f} (bound "
          f"{TRAIN_GRAD_RTOL}); {moved} of {len(before)} parameter tensors "
          f"changed", flush=True)
    require(math.isfinite(loss_k) and abs(loss_k - loss_p) <= TRAIN_LOSS_ATOL,
            f"losses {loss_k} vs {loss_p}")
    require(all(torch.isfinite(g).all() for g in grads_k.values()),
            "a kernel-path gradient is not finite")
    require(rel[worst] <= TRAIN_GRAD_RTOL, f"gradient of {worst}: {rel[worst]}")
    require(moved == len(before), f"only {moved} of {len(before)} tensors changed")
    del grads_k, grads_p, before, state_k, state_p, step_k, step_p
    torch.cuda.empty_cache()

    # throughput of the step alone (batches already on the card), and peak
    # memory without remat
    def steps_per_s(step, n=6):
        step(batches[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            step(batches[(i + 1) % len(batches)])
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)

    noisy = train_config("", remat=False)
    state_k, step_k, _, _ = make_trainer(noisy, corpus, args.seed)
    rates = {"kernel": [], "plain": []}
    torch.cuda.reset_peak_memory_stats()
    rates["kernel"].append(steps_per_s(step_k) * TRAIN_BATCH)
    noremat_peak = torch.cuda.max_memory_allocated() / 2**30
    with plain_attention():  # the same state: only the ops differ
        rates["plain"].append(steps_per_s(step_k) * TRAIN_BATCH)
        rates["plain"].append(steps_per_s(step_k) * TRAIN_BATCH)
    rates["kernel"].append(steps_per_s(step_k) * TRAIN_BATCH)
    print(f"[11 train] train step img/s at batch {TRAIN_BATCH}, dropout and "
          f"drop path on, no remat, 6 steps per run on batches already on the "
          f"card (kernel, plain, plain, kernel): kernel {rates['kernel']}, "
          f"plain {rates['plain']}; peak device memory of the kernel path "
          f"{noremat_peak:.2f} GiB (remat: {remat_peak:.2f}); {kind}, {smi}",
          flush=True)
    if args.profile_train:
        profile_train_steps(step_k, batches, args.profile_train,
                            TRAIN_BATCH / rates["kernel"][-1] * 1e3)
    return kept


def device_cache_runs(args, corpus, workdir: str, kind: str, smi: str) -> None:
    """Phase 11, the corpus on the card: ``train()`` on the packed transport
    streaming (``data.device_cache=false``) and from the card (``true``, the
    batches gathered there), in turns: false, true, true, false. The batches
    are the same bytes and the augmentation and dropout streams are seeded
    by the step, so the per-epoch metrics of all four runs must be equal; K2
    and K3 12 times a train step in each. img/s from warm steps only: the
    time from one train step's end to the next's within an epoch (the card
    synchronized at each), which leaves out each epoch's first step."""
    import torch

    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.train.__main__ import train

    tag = "[11 train device cache]"
    depth = 12
    runs = []
    for flag in (False, True, True, False):
        save_dir = os.path.join(workdir, f"train_cache_{flag}")
        cfg = train_config(save_dir)
        cfg["data"].update(transport="packed", device_cache=flag)
        per_step = []

        def on_step(step_kind, sums):
            torch.cuda.synchronize()
            per_step.append((step_kind, *attention_counts(),
                             time.perf_counter()))
            attn_ops.LAUNCHES = attn_ops.BWD_LAUNCHES = 0

        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            result = train(cfg, corpus, seed=args.seed, device="cuda",
                           on_step=on_step)
            torch.cuda.synchronize()
        finally:
            shutil.rmtree(save_dir, ignore_errors=True)
        launches = {k: sorted({s[1:3] for s in per_step if s[0] == k})
                    for k in ("train", "eval")}
        warm = [b[3] - a[3] for a, b in zip(per_step, per_step[1:])
                if a[0] == b[0] == "train"]
        runs.append({"flag": flag, "history": result["history"],
                     "launches": launches, "warm_steps": len(warm),
                     "warm_img_s": TRAIN_BATCH * len(warm) / sum(warm),
                     "seconds": time.perf_counter() - t0,
                     "cache": result["device_cache"],
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        del result
        torch.cuda.empty_cache()
    for run in runs:
        h = run["history"]
        cache = run["cache"]
        print(f"{tag} data.device_cache={str(run['flag']).lower()} (packed "
              f"transport): {run['seconds']:.1f} s; (K2, K3) launches per step "
              f"{run['launches']}; bytes to the card a train step "
              f"{[e['bytes_to_device_per_step'] for e in h]}; train img/s on "
              f"{run['warm_steps']} warm steps {run['warm_img_s']:.1f} (by "
              f"epoch, first step included: "
              f"{[round(e['train_img_per_s'], 1) for e in h]}); corpus on "
              f"the card {'none' if cache is None else str(cache['bytes']) + ' bytes, built in ' + format(cache['seconds'], '.2f') + ' s'}; "
              f"peak device memory {run['peak_gib']:.2f} GiB; {kind}, {smi}",
              flush=True)
        require(run["launches"] == {"train": [(depth, depth)],
                                    "eval": [(depth, 0)]},
                f"{tag} attention launches per step {run['launches']}")
        require((run["cache"] is not None) == run["flag"],
                f"{tag} the cache engaged where it should not, or not at all")
    print(f"{tag} warm-step train img/s in turns (streaming, from the card, "
          f"from the card, streaming): "
          f"{[round(run['warm_img_s'], 1) for run in runs]}", flush=True)
    first = runs[0]["history"]
    differ = [(i, e["epoch"], split) for i, run in enumerate(runs[1:], 1)
              for a, e in zip(first, run["history"])
              for split in ("train", "val") if a[split] != e[split]]
    print(f"{tag} per-epoch metrics of the four runs: "
          f"{'equal' if not differ else f'differ at {differ}'}; train "
          f"{[e['train'] for e in first]}", flush=True)
    require(all(len(run["history"]) == 2 for run in runs) and not differ,
            f"{tag} the metrics differ at (run, epoch, split) {differ}")
    cached = runs[1]["history"]
    require(cached[0]["bytes_to_device_per_step"] == 4 * TRAIN_BATCH,
            f"{tag} a cached step sent {cached[0]['bytes_to_device_per_step']} "
            f"bytes, not its index row")


def step_with_grads(state, train_step, batch, aug, update: bool = True):
    """One train step; returns its gradients and its loss. ``update`` False
    leaves the update out, so that a second step (through plain attention)
    starts from the same weights and step."""
    import torch

    grads = {}
    apply = state.apply_gradients

    def capture():
        grads.update({n: p.grad.detach().clone()
                      for n, p in zip(state.names, state.params)})
        if update:
            return apply()
        for p in state.params:
            p.grad = None
        return torch.zeros((), device=state.params[0].device)

    state.apply_gradients = capture
    try:
        sums = train_step(batch, aug)
    finally:
        del state.apply_gradients  # the class's method again, no cycle
    return grads, sums["step_loss"].item()


def profile_train_steps(train_step, batches, steps: int, step_ms: float) -> None:
    """``torch.profiler`` over warm train steps: kernels by device time, and
    the device's idle share of an unprofiled step of ``step_ms``; the
    augmentation alone, by CUDA events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chess_vision_tpu_torch.augment import draw_params, preprocess_train_batch

    aug = draw_params(TRAIN_BATCH, torch.Generator(device="cuda").manual_seed(0))
    half = (0.5, 0.5, 0.5)
    aug_ms = cuda_ms(
        lambda: preprocess_train_batch(batches[0], aug, half, half), 5)
    train_step(batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            train_step(batches[i % len(batches)])
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3 / steps
    print(f"[11 train] profile of {steps} train steps: device {device_ms:.2f} ms "
          f"per step; a step takes {step_ms:.2f} ms unprofiled (idle share "
          f"{1 - device_ms / step_ms:.3f}) and {wall_ms:.1f} ms under the "
          f"profiler; augmentation + normalize alone {aug_ms:.3f} ms",
          flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=45,
                       max_name_column_width=60), flush=True)


EVAL_BOARDS = 512
MANIFEST_HEADER = ["filename", "fen", "legal", "turn", "castling", "en_passant",
                   "piece_count", "has_highlight", "style", "flipped"]


def write_eval_boards(out_dir: str, count: int, seed: int) -> int:
    """``count`` random uint8 boards as JPEGs, with a ``manifest.csv`` in the
    generator's schema and labels from ``random_fen``; every eighth board is
    an illegal one (legal 0, white to move, no castling), as the generator's
    random positions are. Returns the number of legal boards."""
    import csv

    from PIL import Image

    rng = np.random.default_rng(seed + 2)
    os.makedirs(out_dir)
    rows = []
    for i in range(count):
        legal = i % 8 != 7
        placement, turn, castling, ep = random_fen(rng).split()[:4]
        if not legal:
            turn, castling = "w", "-"
        name = f"{i:06d}.jpg"
        Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
                        ).save(os.path.join(out_dir, name), quality=90)
        rows.append([name, f"{placement} {turn} {castling} {ep}", int(legal),
                     turn, castling, ep, sum(c.isalpha() for c in placement),
                     0, "noise", 0])
    with open(os.path.join(out_dir, "manifest.csv"), "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(MANIFEST_HEADER)
        writer.writerows(rows)
    return sum(int(r[2]) for r in rows)


def eval_phase(args, cfg, params, train_ckpt: str, workdir: str) -> None:
    """Phase 17: evaluation on the card, in process on the model of phase 5,
    and its CLIs in subprocesses on phase 11's checkpoint."""
    import torch

    from chess_vision_tpu_torch import evaluate as ev
    from chess_vision_tpu_torch.augment import preprocess_eval_batch
    from chess_vision_tpu_torch.config import get_data_config
    from chess_vision_tpu_torch.data import BatchLoader, ChessDataset
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.serve import Predictor

    tag = "[17 eval]"
    depth = cfg["model"]["depth"]
    test_dir = os.path.join(workdir, "eval")
    t0 = time.perf_counter()
    n_legal = write_eval_boards(test_dir, EVAL_BOARDS, args.seed)
    write_s = time.perf_counter() - t0
    model = Predictor((cfg, params), batch_size=BATCH, device="cuda").model
    data_cfg = get_data_config(cfg["model"]["name"])
    mean, std = data_cfg["mean"], data_cfg["std"]
    dataset = ChessDataset(test_dir, input_size=SIZE)
    require(dataset.use_manifest and len(dataset) == EVAL_BOARDS,
            f"{tag} {len(dataset)} boards, manifest {dataset.use_manifest}")

    # every eval batch with its outputs and the K2 launches it made
    seen = []
    make_eval_batch_fn = ev.make_eval_batch_fn

    def recording(*fn_args):
        eval_batch = make_eval_batch_fn(*fn_args)

        def run(batch):
            before = attn_ops.LAUNCHES
            out = eval_batch(batch)
            seen.append((batch, out, attn_ops.LAUNCHES - before))
            return out

        return run

    loader = BatchLoader(dataset, np.arange(len(dataset)), BATCH, num_workers=8)
    reset_counts()
    t0 = time.perf_counter()
    with mock.patch.object(ev, "make_eval_batch_fn", recording):
        metrics = ev.evaluate(model, dataset, loader, mean, std, verbose=False)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    batches = math.ceil(EVAL_BOARDS / BATCH)
    launches = [s[2] for s in seen]
    print(f"{tag} {EVAL_BOARDS} boards ({n_legal} legal) written in "
          f"{write_s:.1f} s; evaluate at batch {BATCH} on the model of phase 5 "
          f"in {eval_s:.2f} s (decode included, {EVAL_BOARDS / eval_s:.0f} "
          f"boards/s): K2 launches per eval batch {launches}; metrics "
          f"{metrics}", flush=True)
    require(launches == [depth] * batches,
            f"{tag} K2 launches per eval batch {launches}")
    require(attn_ops.LAUNCHES == depth * batches,
            f"{tag} {attn_ops.LAUNCHES} K2 launches in all")

    # the device sums against the same counts taken on the host from the
    # per-sample predictions and flags
    host = dict.fromkeys(("loss_sum", *ev.COUNT_KEYS), 0)
    conf = np.zeros((13, 13), np.int64)
    turn_conf = torch.zeros((2, 2), dtype=torch.int64)
    rights = np.zeros(4, np.int64)
    device = None
    for batch, out, _ in seen:
        res = out["results"].cpu().numpy().astype(np.int64)
        real = batch["mask"].cpu().numpy() > 0
        labels = batch["squares"].cpu().numpy()
        legal = (batch["legal"][:, 0].cpu().numpy() > 0) & real
        preds = res[:, :64]
        board_ok, turn_ok, cast_ok = (res[:, 64:67] > 0).T
        require((res[:, 67] == (preds != labels).sum(1) * real).all()
                and (board_ok == ((preds == labels).all(1) & real)).all(),
                f"{tag} per-sample flags differ from the predictions")
        host["squares_correct"] += int(((preds == labels) & real[:, None]).sum())
        host["boards_correct"] += int(board_ok.sum())
        host["turn_correct_legal"] += int((turn_ok & legal).sum())
        host["castling_all_correct_legal"] += int((cast_ok & legal).sum())
        host["full_fen_correct_legal"] += int(
            (board_ok & turn_ok & cast_ok & legal).sum())
        host["n_legal"] += int(legal.sum())
        host["n"] += int(real.sum())
        np.add.at(conf, (labels[real].ravel(), preds[real].ravel()), 1)
        turn_conf += out["turn_conf"].cpu()
        rights += out["castling_right_correct_legal"].cpu().numpy()
        device = out if device is None else {
            k: v if k == "results" else device[k] + v for k, v in out.items()}
    sums = {k: int(device[k]) for k in ev.COUNT_KEYS}
    host["loss_sum"] = float(device["loss_sum"])
    n = max(host["n"], 1)
    nl = max(host["n_legal"], 1)
    recomputed = {
        "loss": host["loss_sum"] / n,
        "square_acc": host["squares_correct"] / (n * 64),
        "board_acc": host["boards_correct"] / n,
        "turn_acc": host["turn_correct_legal"] / nl,
        "castling_acc": host["castling_all_correct_legal"] / nl,
        "full_fen_acc": host["full_fen_correct_legal"] / nl,
        "total_boards": host["n"], "total_legal": host["n_legal"]}
    same_conf = bool((device["conf"].cpu().numpy() == conf).all())
    print(f"{tag} device sums {sums} vs host {dict((k, host[k]) for k in sums)}; "
          f"13x13 confusion equal {same_conf}; turn confusion "
          f"{turn_conf.tolist()}, castling rights {rights.tolist()}", flush=True)
    require(sums == {k: host[k] for k in ev.COUNT_KEYS},
            f"{tag} device sums {sums} differ from the host's")
    require(same_conf, f"{tag} the 13x13 confusion differs from the host's")
    require(int(turn_conf.sum()) == host["n_legal"]
            and int(turn_conf.trace()) == host["turn_correct_legal"],
            f"{tag} turn confusion {turn_conf.tolist()}")
    require(host["n"] == EVAL_BOARDS and host["n_legal"] == n_legal,
            f"{tag} {host['n']} boards, {host['n_legal']} legal")
    require(metrics == recomputed,
            f"{tag} metrics {metrics} differ from the host's {recomputed}")

    # the predictions against the plain-attention forward on the same batches
    counts = attention_counts()
    mismatch = confident = 0
    with torch.no_grad(), plain_attention():
        for batch, out, _ in seen:
            logits = model(preprocess_eval_batch(batch, mean, std))["squares"]
            logits = logits.float().reshape(-1, 64, 13)
            top2 = logits.topk(2, dim=-1).values
            bound = SQUARES_ULPS * torch.from_numpy(row_unit(
                logits.reshape(len(logits), -1).cpu().numpy())).to(logits.device)
            sure = ((top2[..., 0] - top2[..., 1] > 2 * bound[:, None])
                    & (batch["mask"] > 0)[:, None])
            preds = out["results"][:, :64].long()
            confident += int(sure.sum())
            mismatch += int(((preds != logits.argmax(-1)) & sure).sum())
    require(attention_counts() == counts, f"{tag} the plain forward launched K2")
    print(f"{tag} predictions vs the plain-attention forward: {confident} of "
          f"{EVAL_BOARDS * 64} squares have top-2 margin > twice their "
          f"board's bound ({SQUARES_ULPS} units of its scale), "
          f"{mismatch} differ", flush=True)
    require(mismatch == 0, f"{tag} {mismatch} confident squares differ from plain")
    del seen, model, device

    # the CLIs, in subprocesses, on phase 11's checkpoint
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONUNBUFFERED": "1"}
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "chess_vision_tpu_torch.evaluate", "--checkpoint",
         train_ckpt, "--test-dir", test_dir, "--batch-size", str(BATCH)],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    require(r.returncode == 0, f"{tag} evaluate CLI exit {r.returncode}: "
                               f"{r.stderr[-2000:]}")
    log = os.path.join(os.path.dirname(train_ckpt), "eval_results.jsonl")
    with open(log) as f:
        row = json.loads(f.read().splitlines()[-1])
    m = row["metrics"]
    print(f"{tag} python -m chess_vision_tpu_torch.evaluate on phase 11's "
          f"checkpoint ({cli_s:.1f} s, start-up included): eval_results.jsonl "
          f"row {row}", flush=True)
    require(row["num_samples"] == EVAL_BOARDS and m["total_boards"] == EVAL_BOARDS
            and m["total_legal"] == n_legal and math.isfinite(m["loss"])
            and all(0.0 <= m[k] <= 1.0 for k in recomputed
                    if k.endswith("_acc")),
            f"{tag} eval_results.jsonl row {row}")
    require("EVALUATION RESULTS" in r.stdout and "GROUPED METRICS" in r.stdout,
            f"{tag} evaluate CLI report: {r.stdout[-2000:]}")

    for mode in ("ycbcr420", "rgb"):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "chess_vision_tpu_torch.experiments.int8_eval",
             "--checkpoint", train_ckpt, "--test-dir", test_dir, "--max-samples",
             str(EVAL_BOARDS), "--calib", "8", "--mode", mode],
            cwd=root, env={**env, "CHESS_VISION_INT8_LAYOUT": "block"},
            capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        require(r.returncode == 0, f"{tag} int8_eval --mode {mode} exit "
                                   f"{r.returncode}: {r.stderr[-2000:]}")
        try:
            out = json.loads(r.stdout)
        except ValueError:
            out = None
        require(isinstance(out, dict) and out.get("layout") == "block"
                and out.get("mode") == mode
                and out["bf16"]["n"] == out["int8"]["n"] == EVAL_BOARDS,
                f"{tag} int8_eval output {r.stdout[-2000:]}")
        print(f"{tag} python -m chess_vision_tpu_torch.experiments.int8_eval "
              f"--calib 8 --mode {mode} under the block layout ({cli_s:.1f} s): "
              f"int8 vs bf16 on phase 11's weights (8 steps of training; not "
              f"gated): square agreement {out['square_agreement']}, board "
              f"agreement {out['board_agreement']}; board acc bf16 "
              f"{out['bf16']['board_acc']}, int8 {out['int8']['board_acc']}",
              flush=True)



# The CNN and square archs (phases 18 and 19) at full width, in the config
# keys of ``configs/cnn.yaml`` and ``configs/square.yaml``.
ARCH_WIDTH = {
    "cnn": {"arch": "cnn", "name": "convnextv2_tiny.fcmae_ft_in22k_in1k",
            "input_size": SIZE},
    "square": {"arch": "square",
               "name": "mobilenetv4_conv_small_050.e3000_r224_in1k",
               "input_size": SIZE, "square_input_size": 64,
               "square_overlap": 1.5},
}
# The card's bf16 forward against the port's f32 forward on the CPU, per
# board, in units of the row's scale (``row_unit``: its RMS logit over 256,
# about one bf16 ulp at that magnitude). bf16 rounds every activation to 8
# significant bits (2^-9 relative) at each of the ~80 (cnn) and ~60 (square)
# convolutions, products and norms, and the weights once; independent
# roundings add in quadrature and the residual stream carries them, so the
# logits land some ulps apart. Read on the card at 256 px, full width
# (NVIDIA H100 80GB HBM3, 700.00 W): 9.44 (cnn) and 9.88 (square) units; the
# planted faults 755.3 (cnn: GRN's gamma and beta swapped) and 35,734.8
# (square: BatchNorm in batch-statistics mode).
F32_UNITS = 32
ARCH_EVAL_BOARDS = 64


def arch_variables(arch: str, seed: int) -> tuple[dict, dict]:
    """The config and JAX-layout variables ({"params", "batch_stats"}) of a
    full-width model drawn by ``init_weights`` from ``seed`` and carried
    back through the inverse bridge. GRN's gamma and beta, zero at init, are
    drawn N(0, 0.2) so that the GRN takes part (and a fault in it shows);
    BatchNorm keeps the init's statistics (mean 0, variance 1)."""
    import torch

    from chess_vision_tpu_torch.convert.jax_params import variables_from_state_dict
    from chess_vision_tpu_torch.models import build_model, init_weights
    from chess_vision_tpu_torch.models.layers import GRN

    cfg = {"model": dict(ARCH_WIDTH[arch]), "training": {"mixed_precision": True}}
    model = init_weights(build_model(cfg), seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, GRN):
                module.weight.normal_(0.0, 0.2, generator=gen)
                module.bias.normal_(0.0, 0.2, generator=gen)
    return cfg, variables_from_state_dict(model.state_dict())


@contextmanager
def arch_fault(arch: str):
    """The planted fault of each arch: GRN's gamma and beta swapped (cnn);
    the backbone's BatchNorm normalizing with the batch's statistics
    (square)."""
    import torch

    from chess_vision_tpu_torch.models import layers

    def swapped(self, x):
        xf = x.float()
        gx = torch.sqrt(torch.sum(xf * xf, dim=(1, 2), keepdim=True))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return (self.bias.float() * (xf * nx) + self.weight.float()
                + xf).to(x.dtype)

    def batch_mode(self, x):
        return layers.batch_norm(x, *layers.batch_moments(x), self.weight,
                                 self.bias, self.eps)

    if arch == "cnn":
        patch = mock.patch.object(layers.GRN, "forward", swapped)
    else:
        patch = mock.patch.object(layers.BatchNorm, "forward", batch_mode)
    with patch:
        yield


def arch_serve(number: int, arch: str, args, kernels: dict, kind: str,
               smi: str) -> None:
    """Phases 18 and 19, serving: ``Predictor.predict_array`` at full width
    in rgb (K1 once a batch, no other kernel) and ycbcr420 (no kernel);
    logits bit-equal to the plain ops'; the card's bf16 against the port's
    f32 forward on the CPU on 8 boards (F32_UNITS), the planted fault
    outside; boards/s of both modes in turns, peak memory and, with
    ``--profile-arch``, the kernels that take the device time."""
    import torch

    from chess_vision_tpu_torch.convert.jax_params import state_dict_from_jax
    from chess_vision_tpu_torch.experiments.plain import forward_logits
    from chess_vision_tpu_torch.fen import assemble_fens_batch
    from chess_vision_tpu_torch.models import build_model
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import preprocess as pre_ops
    from chess_vision_tpu_torch.serve import Predictor

    tag = f"[{number} {arch}]"
    torch.backends.cudnn.benchmark = False  # one algorithm per shape
    cfg, variables = arch_variables(arch, args.seed)
    ckpt = (cfg, variables["params"], variables["batch_stats"])
    t0 = time.perf_counter()
    predictor = Predictor(ckpt, batch_size=BATCH, device="cuda")
    rng = np.random.default_rng(args.seed + number)
    boards = rng.integers(0, 256, (args.boards, SIZE, SIZE, 3), dtype=np.uint8)
    predictor.predict_array(boards[:BATCH])  # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    batches = math.ceil(args.boards / BATCH)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    fens = predictor.predict_array(boards)
    counts = int8_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    moved = {k: v for k, v in counts.items() if v}
    print(f"{tag} {arch} {SIZE}px bf16 full width, {args.boards} boards in "
          f"{batches} batches of {BATCH}: launches {moved} (set-up "
          f"{setup_s:.1f} s); peak device memory {peak_gib:.2f} GiB", flush=True)
    require(moved == {"preprocess_u8": batches},
            f"{tag} launch counts {moved} for {batches} batches")
    kernels["preprocess_u8"]["launches"] += counts["preprocess_u8"]

    with plain_ops(attn_ops, pre_ops):
        fens_plain = predictor.predict_array(boards)
        logits_p = forward_logits(predictor, boards)
        require(pre_ops.LAUNCHES == counts["preprocess_u8"],
                f"{tag} the plain-ops run launched K1")
    logits_k = forward_logits(predictor, boards)
    same = {k: bool(np.array_equal(logits_k[k], logits_p[k])) for k in logits_k}
    print(f"{tag} logits with K1 vs the plain preprocess (cudnn.benchmark off): "
          f"bit-equal {same}; {sum(a == b for a, b in zip(fens, fens_plain))}/"
          f"{len(fens)} FEN strings identical", flush=True)
    require(all(same.values()) and fens == fens_plain,
            f"{tag} the kernel path's logits are not the plain path's: {same}")

    # the card (bf16) against the port's f32 forward on the CPU
    n = 8
    mean, std = mean_std(cfg)
    cpu_cfg = {"model": cfg["model"], "training": {"mixed_precision": False}}
    cpu_model = build_model(cpu_cfg)
    cpu_model.load_state_dict(state_dict_from_jax(
        variables["params"], cpu_cfg, variables["batch_stats"]))
    x = pre_ops.preprocess_u8_plain(torch.from_numpy(boards[:n]), mean, std,
                                    torch.float32)
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = {k: v.numpy() for k, v in cpu_model(x).items()}
    cpu_s = time.perf_counter() - t0
    ids = ref["squares"].reshape(n, 64, 13).argmax(-1)
    fens_cpu = assemble_fens_batch(ids, ref["turn"], ref["castling"])
    print(f"{tag} the port's f32 forward of {n} boards on the CPU: "
          f"{cpu_s:.1f} s", flush=True)
    card = {k: v[:n] for k, v in logits_k.items()}
    require_logits(f"{tag} card bf16 vs CPU f32:", fens[:n], fens_cpu, card, ref,
                   F32_UNITS)
    with arch_fault(arch):
        logits_f = forward_logits(predictor, boards[:n])
    what = ("GRN's gamma and beta swapped" if arch == "cnn" else
            "the backbone's BatchNorm in batch-statistics mode")
    require_planted(f"{tag} card vs CPU f32:", what, logits_f, ref, F32_UNITS)
    del cpu_model, x

    # ycbcr420: the planes rebuilt in PyTorch, no kernel
    pred_y = Predictor(ckpt, batch_size=BATCH, device="cuda", mode="ycbcr420")
    pred_y.predict_array(boards[:BATCH])
    torch.cuda.synchronize()
    reset_counts()
    fens_y = pred_y.predict_array(boards)
    moved_y = {k: v for k, v in int8_counts().items() if v}
    agree = np.mean([a == b for fa, fb in zip(fens, fens_y)
                     for a, b in zip(fa.split()[0], fb.split()[0])])
    print(f"{tag} ycbcr420: launches {moved_y}; against rgb mode (the inputs "
          f"differ; not gated): {sum(a == b for a, b in zip(fens, fens_y))}/"
          f"{len(fens)} FEN strings identical, placement characters agree "
          f"{agree:.4f}", flush=True)
    require(not moved_y, f"{tag} ycbcr420 launched {moved_y}")

    bench = np.concatenate([boards] * math.ceil(args.bench_boards / args.boards))
    bench = bench[:args.bench_boards]
    rates = {"rgb": [], "ycbcr420": []}
    for which in ("rgb", "ycbcr420", "ycbcr420", "rgb"):
        pred = pred_y if which == "ycbcr420" else predictor
        t0 = time.perf_counter()
        pred.predict_array(bench)
        rates[which].append(len(bench) / (time.perf_counter() - t0))
    print(f"{tag} predict_array boards/s at batch {BATCH} ({len(bench)} boards "
          f"per run; rgb, ycbcr420, ycbcr420, rgb): {rates}; {kind}, {smi}",
          flush=True)
    if args.profile_arch:
        profile_forward(tag, predictor, boards[:BATCH])
        if arch == "cnn":
            depthwise_reading(tag, predictor.model)
    del predictor, pred_y
    torch.cuda.empty_cache()


def profile_forward(tag: str, predictor, boards) -> None:
    """One batch through the Predictor's forward under ``torch.profiler``:
    the device time by kernel, the top ones printed with their share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    u8 = torch.from_numpy(boards).to(predictor.device)
    predictor.infer(u8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        predictor.infer(u8)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    total = sum(t for _, t in rows)
    rows.sort(key=lambda r: -r[1])
    conv = sum(t for k, t in rows if any(
        w in k.lower() for w in ("conv", "cudnn", "xmma", "implicit", "dgrad",
                                 "wgrad", "fprop")))
    top = "; ".join(f"{k[:70]} {t / 1e3:.3f} ms ({t / max(total, 1):.1%})"
                    for k, t in rows[:8])
    print(f"{tag} torch.profiler, one batch of {len(boards)} through the "
          f"forward: device time {total / 1e3:.3f} ms, kernels whose name "
          f"reads as a cuDNN convolution {conv / max(total, 1):.1%}; top: {top}",
          flush=True)


def depthwise_reading(tag: str, model) -> None:
    """cuDNN's 7x7 depthwise convolution of each ConvNeXt stage at batch
    256, bf16, channels_last (an NHWC tensor's NCHW view), by CUDA events,
    beside the bytes it must move (input and output once, over 3.35 TB/s)."""
    import torch

    from chess_vision_tpu_torch.models.layers import conv2d

    parts = []
    for s, stage in enumerate(model.backbone.stages):
        conv = stage.blocks[0].conv_dw
        hw = SIZE // 4 >> s
        x = torch.randn((BATCH, hw, hw, conv.in_channels), device="cuda",
                        dtype=torch.bfloat16)
        ms = cuda_ms(lambda: conv2d(x, conv), 20)
        bound = 2 * x.numel() * 2 / HBM_BYTES_PER_S * 1e3
        parts.append(f"stage {s} {tuple(x.shape)} {ms:.4f} ms (bound "
                     f"{bound:.4f}, {len(stage.blocks)} a forward)")
    print(f"{tag} depthwise 7x7, cuDNN: {'; '.join(parts)}", flush=True)


def arch_train_config(arch: str, save_dir: str, **model_overrides) -> dict:
    """``configs/<arch>.yaml`` with the in-memory corpus of phase 11: batch
    64, 2 epochs, no pretrained weights, no OOD set."""
    from chess_vision_tpu_torch.config import load_config

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, "configs", f"{arch}.yaml"))
    cfg["data"].update(val_split=0.2, num_workers=4, max_samples=None,
                       ood_val_dir="")
    cfg["model"].update(pretrained=False, **model_overrides)
    cfg["training"].update(epochs=2, batch_size=TRAIN_BATCH)
    cfg["checkpointing"]["save_dir"] = save_dir
    cfg["logging"]["tensorboard_dir"] = save_dir + "/runs"
    return cfg


def arch_train(number: int, arch: str, args, corpus, workdir: str, kind: str,
               smi: str, **model_overrides) -> tuple[str, dict]:
    """``train()`` on ``configs/<arch>.yaml`` values, 2 epochs of 4 steps:
    no kernel launched, finite losses, the last epoch's mean train loss below
    the first's, warm-step img/s, the checkpoint written and read back.
    Returns the checkpoint's path and the trained state's running
    statistics."""
    import torch

    from chess_vision_tpu_torch.train.__main__ import train
    from chess_vision_tpu_torch.utils.checkpoint import load_checkpoint

    tag = f"[{number} {arch}]"
    name = arch + "".join(f"_{k}={v}" for k, v in model_overrides.items())
    save_dir = os.path.join(workdir, name)
    stamps = []

    def on_step(step_kind, sums):
        torch.cuda.synchronize()
        stamps.append((step_kind, time.perf_counter(),
                       sums.get("step_loss", sums["loss_sum"])))

    cfg = arch_train_config(arch, save_dir, **model_overrides)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = train(cfg, corpus, seed=args.seed, device="cuda", on_step=on_step)
    train_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    moved = {k: v for k, v in int8_counts().items() if v}
    history = result["history"]
    losses = [float(s[2]) for s in stamps if s[0] == "train"]
    # warm steps: a train step that follows a train step
    gaps = [b[1] - a[1] for a, b in zip(stamps, stamps[1:])
            if a[0] == b[0] == "train"]
    warm = TRAIN_BATCH / float(np.median(gaps)) if gaps else float("nan")
    print(f"{tag} train() {name}, batch {TRAIN_BATCH}: {len(losses)} train "
          f"steps in {train_s:.1f} s (evaluation and checkpoints included); "
          f"launches {moved}; step losses {[round(x, 4) for x in losses]}; "
          f"epoch train losses {[h['train']['loss'] for h in history]}, val "
          f"{[h['val']['loss'] for h in history]}; warm train step img/s "
          f"{warm:.1f} (median of {len(gaps)} step intervals); peak device "
          f"memory {peak_gib:.2f} GiB; {kind}, {smi}", flush=True)
    require(len(losses) == 8 and not moved,
            f"{tag} {len(losses)} train steps, launches {moved}")
    require(all(math.isfinite(x) for x in losses), f"{tag} step losses {losses}")
    require(history[-1]["train"]["loss"] < history[0]["train"]["loss"],
            f"{tag} the mean train loss did not fall")
    path = os.path.join(save_dir, "latest.ckpt")
    ckpt = load_checkpoint(path)
    require(ckpt["step"] == 8 and ckpt["epoch"] == 1
            and ckpt["config"]["model"]["arch"] == arch
            and ckpt["params"]["type_head"]["kernel"].shape[1] == 7,
            f"{tag} the checkpoint read back")
    stats = {k: v.detach().cpu().clone()
             for k, v in result["state"].model.state_dict().items()
             if "running_" in k}
    return path, stats


def arch_eval(number: int, arch: str, ckpt_path: str, test_dir: str) -> dict:
    """``python -m chess_vision_tpu_torch.evaluate`` on a checkpoint in a
    subprocess; its ``eval_results.jsonl`` row must hold the metrics that
    ``evaluate`` gives in process on ``load_model`` of the same file."""
    from chess_vision_tpu_torch.data import BatchLoader, ChessDataset
    from chess_vision_tpu_torch.evaluate import evaluate, load_model

    tag = f"[{number} {arch}]"
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "chess_vision_tpu_torch.evaluate", "--checkpoint",
         ckpt_path, "--test-dir", test_dir, "--batch-size", str(TRAIN_BATCH)],
        cwd=root, env={**os.environ, "PYTHONUNBUFFERED": "1"},
        capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    require(r.returncode == 0, f"{tag} evaluate CLI exit {r.returncode}: "
                               f"{r.stderr[-2000:]}")
    log = os.path.join(os.path.dirname(ckpt_path), "eval_results.jsonl")
    with open(log) as f:
        row = json.loads(f.read().splitlines()[-1])
    model, cfg = load_model(ckpt_path)
    dataset = ChessDataset(test_dir, input_size=SIZE)
    loader = BatchLoader(dataset, np.arange(len(dataset)), TRAIN_BATCH,
                         num_workers=4)
    mean, std = mean_std(cfg)
    here = evaluate(model, dataset, loader, mean, std, verbose=False)
    print(f"{tag} python -m chess_vision_tpu_torch.evaluate ({cli_s:.1f} s, "
          f"start-up included): eval_results.jsonl metrics {row['metrics']}; "
          f"in process on load_model of the same file {here}", flush=True)
    require(row["num_samples"] == ARCH_EVAL_BOARDS
            and row["metrics"] == json.loads(json.dumps(here))
            and math.isfinite(here["loss"]),
            f"{tag} the evaluate CLI's row {row} is not the in-process "
            f"evaluation {here}")
    return here


def arch_phase(number: int, arch: str, args, kernels: dict, kind: str,
               smi: str, workdir: str) -> None:
    """Phases 18 (cnn) and 19 (square): serving, then training and the
    evaluate CLI on its checkpoint."""
    import torch

    t_phase = time.perf_counter()
    arch_serve(number, arch, args, kernels, kind, smi)
    tag = f"[{number} {arch}]"
    corpus = MemoryCorpus(320, args.seed)
    test_dir = os.path.join(workdir, f"{arch}_eval")
    write_eval_boards(test_dir, ARCH_EVAL_BOARDS, args.seed + number)
    if arch == "cnn":
        path, _ = arch_train(number, arch, args, corpus, workdir, kind, smi)
        arch_eval(number, arch, path, test_dir)
    else:
        # pinned (the default): the running statistics stay the init's, bit
        # for bit, in the model and in the checkpoint
        path, stats = arch_train(number, arch, args, corpus, workdir, kind, smi,
                                 pin_backbone_bn=True)
        from chess_vision_tpu_torch.utils.checkpoint import load_checkpoint
        from chess_vision_tpu_torch.convert.jax_params import state_dict_from_tree

        saved = state_dict_from_tree(load_checkpoint(path)["batch_stats"])
        init = all(torch.equal(v, torch.zeros_like(v) if "mean" in k
                               else torch.ones_like(v)) for k, v in stats.items())
        print(f"{tag} pinned: {len(stats)} running statistics after 8 steps "
              f"equal the init's bit for bit: {init}; in the checkpoint: "
              f"{saved.keys() == stats.keys() and all(torch.equal(saved[k], stats[k]) for k in stats)}",
              flush=True)
        require(len(stats) == 90 and init and saved.keys() == stats.keys()
                and all(torch.equal(saved[k], stats[k]) for k in stats),
                f"{tag} pinned statistics moved")
        # unpinned: they move by flax's rule and the checkpoint carries them
        path, stats = arch_train(number, arch, args, corpus, workdir, kind, smi,
                                 pin_backbone_bn=False)
        saved = state_dict_from_tree(load_checkpoint(path)["batch_stats"])
        moved = sum(not torch.equal(v, torch.zeros_like(v) if "mean" in k
                                    else torch.ones_like(v))
                    for k, v in stats.items())
        print(f"{tag} unpinned: {moved} of {len(stats)} running statistics "
              f"moved in 8 steps", flush=True)
        require(moved == len(stats) == 90 and saved.keys() == stats.keys()
                and all(torch.equal(saved[k], stats[k]) for k in stats),
                f"{tag} the unpinned statistics did not move into the "
                "checkpoint")
        arch_eval(number, arch, path, test_dir)
    print(f"{tag} phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.cuda.empty_cache()


def attention_counts_all() -> tuple[int, int, int, int]:
    """(K2, K3) in bf16, then in f32."""
    from chess_vision_tpu_torch.ops import attention as attn_ops

    return (*attention_counts(), attn_ops.F32_LAUNCHES,
            attn_ops.F32_BWD_LAUNCHES)


def timed_steps(step, batches, n: int = 4) -> float:
    """img/s of ``n`` warm train steps on batches already on the card."""
    import torch

    step(batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        step(batches[(i + 1) % len(batches)])
    torch.cuda.synchronize()
    return n * TRAIN_BATCH / (time.perf_counter() - t0)


def grad_gap(grads: dict, ref: dict) -> tuple[float, str, bool]:
    """The worst per-tensor max |difference| / max |reference gradient|, its
    tensor, and whether every tensor is bit-equal."""
    import torch

    rel = {n: ((grads[n] - ref[n]).abs().max()
               / ref[n].abs().max().clamp_min(1e-30)).item() for n in ref}
    worst = max(rel, key=rel.get)
    return rel[worst], worst, all(torch.equal(grads[n], ref[n]) for n in ref)


def f32_edges(dev, gen, tag: str) -> None:
    """K2 f32 and K3 f32 against their plain versions at the cluster
    route's ragged edges and past its limit (the backward's long route),
    each head dim: within F32_ATOL, the backward bit-identical twice."""
    import torch

    from chess_vision_tpu_torch.ops import attention as attn_ops

    rows = []
    # 449 and 512: 8 CTAs, the cluster's limit; 577: past it
    for n in (1, 17, 65, 300, 449, 512, 577):
        for dh in (16, 32, 64):
            B, H = 2, 2
            qkv = torch.randn((B, n, 3 * H * dh), device=dev, generator=gen)
            g = torch.randn((B, n, H * dh), device=dev, generator=gen)
            route = attn_ops.bwd_route(n, torch.float32)
            plan = attn_ops.f32_plan(n, backward=route == "f32")
            err = (attn_ops.fused_qkv_attention_fwd(qkv, H)
                   - attn_ops.reference_attention(qkv, H)).abs().max().item()
            dqkv = attn_ops.fused_qkv_attention_bwd(qkv, g, H)
            again = attn_ops.fused_qkv_attention_bwd(qkv, g, H)
            derr = (dqkv - attn_ops.reference_attention_bwd(qkv, g, H)
                    ).abs().max().item()
            same = torch.equal(dqkv, again)
            rows.append((n, dh, route, plan, err, derr, same))
            require(err <= F32_ATOL and derr <= F32_ATOL and same,
                    f"{tag} f32 attention at N={n} Dh={dh} ({route}): "
                    f"{err}, {derr}, deterministic {same}")
    for n, dh, route, plan, err, derr, same in rows:
        print(f"{tag} N={n} Dh={dh}: backward route {route}, plan {plan}; "
              f"forward max |diff| {err:.2e}, backward {derr:.2e}, twice "
              f"bit-identical {same}", flush=True)


def f32_kernel_checks(args, dev, kernels: dict, tag: str) -> None:
    """Phase 20's kernels: the route's edges, the training shape (times
    beside the plain versions' and SDPA's, bound shares, one backward
    launch a call), the backward's long route at 577
    tokens, ptxas's registers and spills."""
    import torch

    from chess_vision_tpu_torch.ops import attention as attn_ops

    gen = torch.Generator(device=dev).manual_seed(args.seed + 20)
    f32_edges(dev, gen, tag)
    H, Dh = 12, 64
    for B, n in ((TRAIN_BATCH, SIZE // 16 * SIZE // 16 + 1),):
        qkv = torch.randn((B, n, 3 * H * Dh), device=dev, generator=gen)
        g = torch.randn((B, n, H * Dh), device=dev, generator=gen)
        out = attn_ops.fused_qkv_attention_fwd(qkv, H)
        dqkv = attn_ops.fused_qkv_attention_bwd(qkv, g, H)
        again = attn_ops.fused_qkv_attention_bwd(qkv, g, H)
        ref = attn_ops.reference_attention(qkv, H)
        dref = attn_ops.reference_attention_bwd(qkv, g, H)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        derr = (dqkv - dref).abs().max().item()
        same = torch.equal(dqkv, again)
        del ref, dref, again
        bwd_kernels = traced_kernels(
            "from chess_vision_tpu_torch.ops import attention as attn\n"
            f"qkv = torch.randn((4, {n}, {3 * H * Dh}), device='cuda')\n"
            f"g = torch.randn((4, {n}, {H * Dh}), device='cuda')\n"
            f"calls['bwd'] = lambda: attn.fused_qkv_attention_bwd(qkv, g, {H})\n"
        ).get("bwd", [])
        ms = cuda_ms(lambda: attn_ops.fused_qkv_attention_fwd(qkv, H), 10)
        bwd_ms = cuda_ms(lambda: attn_ops.fused_qkv_attention_bwd(qkv, g, H), 10)
        plain_ms = cuda_ms(lambda: attn_ops.reference_attention(qkv, H), 3)
        plain_bwd_ms = cuda_ms(
            lambda: attn_ops.reference_attention_bwd(qkv, g, H), 3)
        lib_fwd, lib_bwd = sdpa_ms(qkv, g, H)
        ops = 2 * 2 * B * H * n * n * Dh
        fwd_entry = kernel_entry(
            "fused_qkv_attention_f32", "attention_f32.cu",
            "chess_vision_tpu/ops/attention.py:90", err, ms, plain_ms,
            nbytes=4 * qkv.numel() * 4 // 3, ops=ops, op_type="f32",
            library_ms=lib_fwd)
        bwd_entry = kernel_entry(
            "fused_qkv_attention_bwd_f32", "attention_f32.cu",
            "chess_vision_tpu/ops/attention.py:623", derr, bwd_ms,
            plain_bwd_ms, nbytes=4 * (2 * qkv.numel() + g.numel()),
            ops=ops * 5 // 2, op_type="f32", library_ms=lib_bwd)
        print(f"{tag} f32 attention {tuple(qkv.shape)} H={H}, plan "
              f"{attn_ops.f32_plan(n)}: forward max |diff| {err}, "
              f"backward {derr} (atol {F32_ATOL}), backward twice "
              f"bit-identical {same}, its kernels a call {bwd_kernels}; K2 f32 "
              f"{ms:.4f} ms (bound {fwd_entry['bound_ms']:.4f}, "
              f"{fwd_entry['bound_ms'] / ms:.1%} of it; plain {plain_ms:.4f}, "
              f"scaled_dot_product_attention f32 {lib_fwd:.4f}); K3 f32 "
              f"{bwd_ms:.4f} ms (bound {bwd_entry['bound_ms']:.4f}, "
              f"{bwd_entry['bound_ms'] / bwd_ms:.1%}; plain {plain_bwd_ms:.4f}, "
              f"SDPA backward {lib_bwd:.4f})", flush=True)
        require(err <= F32_ATOL and derr <= F32_ATOL and same,
                f"{tag} f32 attention at {tuple(qkv.shape)}: {err}, {derr}, "
                f"deterministic {same}")
        require(len(bwd_kernels) == 1
                and "attention_bwd_f32_kernel" in bwd_kernels[0],
                f"{tag} the backward ran {bwd_kernels}, not one cluster launch")
        if B == TRAIN_BATCH:
            kernels["fused_qkv_attention_f32"] = fwd_entry
            kernels["fused_qkv_attention_bwd_f32"] = bwd_entry
        del qkv, g, out, dqkv
    torch.cuda.empty_cache()

    # the backward's long route: 16 images of 577 tokens (ViT-B/16 at 384
    # px), 12 heads, on clusters of 10 CTAs; the forward's 80-key ranges in
    # 64-key windows
    B, n = 16, 577
    qkv = torch.randn((B, n, 3 * H * Dh), device=dev, generator=gen)
    g = torch.randn((B, n, H * Dh), device=dev, generator=gen)
    before = attn_ops.F32_BWD_LONG_LAUNCHES
    dqkv = attn_ops.fused_qkv_attention_bwd(qkv, g, H)
    derr = (dqkv - attn_ops.reference_attention_bwd(qkv, g, H)).abs().max().item()
    err = (attn_ops.fused_qkv_attention_fwd(qkv, H)
           - attn_ops.reference_attention(qkv, H)).abs().max().item()
    fwd_long_ms = cuda_ms(lambda: attn_ops.fused_qkv_attention_fwd(qkv, H), 5)
    require(attn_ops.F32_BWD_LONG_LAUNCHES == before + 1 and derr <= F32_ATOL
            and err <= F32_ATOL,
            f"{tag} the long route at {tuple(qkv.shape)}: {derr}, forward {err}")
    long_ms = cuda_ms(lambda: attn_ops.fused_qkv_attention_bwd(qkv, g, H), 5)
    plain_long = cuda_ms(lambda: attn_ops.reference_attention_bwd(qkv, g, H), 2)
    _, lib_long = sdpa_ms(qkv, g, H)
    kernels["fused_qkv_attention_bwd_f32_long"] = kernel_entry(
        "fused_qkv_attention_bwd_f32_long", "attention_f32.cu",
        "chess_vision_tpu/ops/attention.py:623", derr, long_ms, plain_long,
        nbytes=4 * (2 * qkv.numel() + g.numel()),
        ops=5 * 2 * B * H * n * n * Dh, op_type="f32", library_ms=lib_long)
    print(f"{tag} long route {tuple(qkv.shape)}, (clusters, CTAs, warps) "
          f"{attn_ops.long_plan(n, torch.float32)} a head: max |diff| {derr}; "
          f"{long_ms:.4f} ms (plain {plain_long:.4f}, SDPA backward "
          f"{lib_long:.4f}); the forward there, in windows: max |diff| {err}, "
          f"{fwd_long_ms:.4f} ms", flush=True)
    del qkv, g, dqkv
    torch.cuda.empty_cache()
    for dh in (16, 32, 64):
        print(f"{tag} ptxas Dh={dh}: attention_fwd_f32_kernel "
              f"{ptxas_counts('attention_fwd_f32_kernel', dh)}; "
              f"attention_bwd_f32_kernel "
              f"{ptxas_counts('attention_bwd_f32_kernel', dh, 0)}, on the long "
              f"route {ptxas_counts('attention_bwd_f32_kernel', dh, 1)}",
              flush=True)


def f32_phase(args, cfg, params, boards, corpus, kernels: dict, kind: str,
              smi: str) -> None:
    """Phase 20: K2 and K3 on f32 inputs, the f32 trainer and Predictor."""
    import torch

    from chess_vision_tpu_torch.augment import draw_params
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import preprocess as pre_ops
    from chess_vision_tpu_torch.serve import Predictor

    tag = "[20 f32]"
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    f32_kernel_checks(args, dev, kernels, tag)

    # the main path: 4 train steps of the f32 model, counted one by one
    f32_cfg = train_config("", remat=False)
    f32_cfg["training"]["mixed_precision"] = False
    state, step, _, batches = make_trainer(f32_cfg, corpus, args.seed)
    torch.cuda.reset_peak_memory_stats()
    per_step = []
    reset_counts()
    t0 = time.perf_counter()
    for batch in batches[:4]:
        before = attention_counts_all()
        loss = step(batch)["step_loss"].item()
        per_step.append((tuple(a - b for a, b in zip(attention_counts_all(),
                                                       before)), loss))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = attention_counts_all()
    peak = torch.cuda.max_memory_allocated() / 2**30
    rate = timed_steps(step, batches)
    print(f"{tag} ViT-B/16 f32 (training.mixed_precision=false), batch "
          f"{TRAIN_BATCH}, configs/vit.yaml values: 4 steps in {train_s:.1f} s "
          f"(first included); (K2, K3, f32 K2, f32 K3) launches per step "
          f"{[c for c, _ in per_step]}; losses "
          f"{[round(x, 4) for _, x in per_step]}; warm {rate:.1f} img/s; peak "
          f"{peak:.2f} GiB; {kind}, {smi}", flush=True)
    require(all(c == (0, 0, 12, 12) for c, _ in per_step),
            f"{tag} launches per step {per_step}")
    require(all(math.isfinite(x) for _, x in per_step), f"{tag} losses")
    kernels["fused_qkv_attention_f32"]["launches"] += launches[2]
    kernels["fused_qkv_attention_bwd_f32"]["launches"] += launches[3]
    # the f32 step with model.remat=true (K2 again in the recompute), in
    # turns with the step above
    remat_cfg = train_config("", remat=True)
    remat_cfg["training"]["mixed_precision"] = False
    state_r, step_r, _, _ = make_trainer(remat_cfg, corpus, args.seed)
    before = attention_counts_all()
    step_r(batches[0])
    per_remat = tuple(a - b for a, b in zip(attention_counts_all(), before))
    require(per_remat == (0, 0, 24, 12), f"{tag} remat launches {per_remat}")
    kernels["fused_qkv_attention_f32"]["launches"] += per_remat[2]
    kernels["fused_qkv_attention_bwd_f32"]["launches"] += per_remat[3]
    turns = [(name, timed_steps(fn, batches)) for name, fn in
             (("false", step), ("true", step_r), ("true", step_r),
              ("false", step))]
    print(f"{tag} f32 step img/s in turns, model.remat "
          f"{', '.join(f'{n} {r:.1f}' for n, r in turns)}; remat=true "
          f"launches a step {per_remat}", flush=True)
    del state, step, state_r, step_r

    # one step's gradients: f32 kernels vs plain attention on the card
    quiet = train_config("", head_dropout=0.0, drop_path_rate=0.0, remat=False)
    quiet["training"]["mixed_precision"] = False
    state_k, step_k, _, _ = make_trainer(quiet, corpus, args.seed)
    state_p, step_p, _, _ = make_trainer(quiet, corpus, args.seed)
    aug = draw_params(TRAIN_BATCH, torch.Generator(device=dev).manual_seed(args.seed))
    grads_k, loss_k = step_with_grads(state_k, step_k, batches[0], aug)
    with plain_attention():
        counts = attention_counts_all()
        grads_p, loss_p = step_with_grads(state_p, step_p, batches[0], aug)
        require(attention_counts_all() == counts,
                f"{tag} the plain step launched a kernel")
    worst, name, equal = grad_gap(grads_k, grads_p)
    print(f"{tag} one f32 step, kernels vs plain attention: loss {loss_k} vs "
          f"{loss_p}; worst per-tensor gradient gap {worst:.3e} at {name} "
          f"(bound {F32_GRAD_RTOL}); bit-equal {equal}", flush=True)
    require(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) and worst <= F32_GRAD_RTOL,
            f"{tag} f32 gradients {worst} at {name}, losses {loss_k}, {loss_p}")
    del state_k, state_p, step_k, step_p, grads_k, grads_p, batches
    torch.cuda.empty_cache()

    # an f32 checkpoint served: K1 (f32 output) and f32 K2 per batch
    cfg32 = {**cfg, "training": {"mixed_precision": False}}
    predictor = Predictor((cfg32, params), batch_size=BATCH, device="cuda")
    require(predictor.model.dtype == torch.float32, f"{tag} model dtype")
    predictor.predict_array(boards[:BATCH])
    reset_counts()
    fens = predictor.predict_array(boards)
    batches_n = math.ceil(len(boards) / BATCH)
    counts = (pre_ops.LAUNCHES, attn_ops.F32_LAUNCHES, attn_ops.LAUNCHES)
    with plain_ops(attn_ops, pre_ops):
        fens_plain = predictor.predict_array(boards)
    t0 = time.perf_counter()
    predictor.predict_array(boards)
    rate = len(boards) / (time.perf_counter() - t0)
    agree = sum(a == b for a, b in zip(fens, fens_plain))
    print(f"{tag} f32 Predictor on {len(boards)} boards: (K1, f32 K2, bf16 K2) "
          f"launches {counts}; FENs equal to its plain path's {agree}/"
          f"{len(boards)}; {rate:.0f} boards/s", flush=True)
    require(counts == (batches_n, 12 * batches_n, 0), f"{tag} launches {counts}")
    require(fens == fens_plain, f"{tag} {len(boards) - agree} FENs differ")
    kernels["fused_qkv_attention_f32"]["launches"] += counts[1]
    del predictor
    torch.cuda.empty_cache()

    # the CNN and square archs in f32: no attention kernel, their
    # convolutions in cuDNN with TF32 off; two train steps and a batch served
    for arch in ("cnn", "square"):
        arch_cfg = arch_train_config(arch, "")
        arch_cfg["training"]["mixed_precision"] = False
        state, step, _, batches = make_trainer(arch_cfg, corpus, args.seed)
        reset_counts()
        losses = [step(batch)["step_loss"].item() for batch in batches[:2]]
        rate = timed_steps(step, batches, 2)
        launches = attention_counts_all()
        del state, step, batches
        served_cfg, variables = arch_variables(arch, args.seed)
        served_cfg["training"]["mixed_precision"] = False
        predictor = Predictor((served_cfg, variables["params"],
                               variables["batch_stats"]), batch_size=BATCH,
                              device="cuda")
        reset_counts()
        fens = predictor.predict_array(boards[:BATCH])
        served = (pre_ops.LAUNCHES, predictor.model.dtype)
        print(f"{tag} {arch} in f32: train losses {losses}, {rate:.1f} img/s "
              f"warm, attention launches {launches}; served {len(fens)} boards, "
              f"(K1 launches, model dtype) {served}", flush=True)
        require(all(math.isfinite(x) for x in losses) and launches == (0, 0, 0, 0)
                and len(fens) == BATCH and served == (1, torch.float32),
                f"{tag} {arch} in f32: {losses}, {launches}, {served}")
        del predictor
        torch.cuda.empty_cache()
    print(f"{tag} phase {time.perf_counter() - t_phase:.1f} s", flush=True)


def remat_phase(args, corpus, kind: str, smi: str) -> None:
    """Phase 21: no remat, "attn_out" and full remat on the bf16 train step."""
    import torch

    from chess_vision_tpu_torch import models
    from chess_vision_tpu_torch.augment import draw_params

    tag = "[21 remat]"
    t_phase = time.perf_counter()
    aug = draw_params(TRAIN_BATCH, torch.Generator(device="cuda").manual_seed(
        args.seed))
    policies = (False, "attn_out", True)
    grads, rows, steps = {}, {}, {}
    for remat in policies:
        state, step, _, batches = make_trainer(train_config("", remat=remat),
                                               corpus, args.seed)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        grads[remat], loss = step_with_grads(state, step, batches[0], aug)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        rows[remat] = (attention_counts_all()[:2], loss, peak)
        steps[remat] = (state, step)
    # img/s in turns, the three trainers alive together
    rates = {remat: [] for remat in policies}
    for remat in (*policies, *policies[::-1]):
        rates[remat].append(timed_steps(steps[remat][1], batches, 6))
    for remat in policies:
        counts, loss, peak = rows[remat]
        print(f"{tag} remat {remat!r}: (K2, K3) launches a step {counts}, loss "
              f"{loss:.6f}, img/s in turns {[round(r, 1) for r in rates[remat]]}, "
              f"peak above the train state {peak / 2**30:.2f} GiB "
              f"({peak / TRAIN_BATCH / 1e6:.1f} MB an image, gradients "
              f"included)", flush=True)
    del steps, batches
    torch.cuda.empty_cache()
    want = {False: (12, 12), "attn_out": (12, 12), True: (24, 12)}
    require(all(rows[r][0] == want[r] for r in policies),
            f"{tag} launches {rows}")
    for remat in ("attn_out", True):
        worst, name, equal = grad_gap(grads[remat], grads[False])
        print(f"{tag} remat {remat!r} gradients against no remat: bit-equal "
              f"{equal}, worst per-tensor gap {worst:.3e} at {name} (bound "
              f"{REMAT_GRAD_RTOL})", flush=True)
        require(worst <= REMAT_GRAD_RTOL, f"{tag} {remat} gradients {worst}")
    print(f"{tag} models.ATTN_OUT_BYTES_PER_IMAGE "
          f"{models.ATTN_OUT_BYTES_PER_IMAGE:.3g}, NOREMAT_BYTES_PER_IMAGE "
          f"{models.NOREMAT_BYTES_PER_IMAGE:.3g}; {kind}, {smi}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def multi_device_phase(args, workdir: str, kind: str, smi: str) -> None:
    """Phase 22: a 1-rank NCCL group through the launcher, and two ranks on
    the one card over gloo."""
    import torch

    from chess_vision_tpu_torch.parallel import dryrun
    from chess_vision_tpu_torch.utils.checkpoint import load_checkpoint

    tag = "[22 multi]"
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    data = os.path.join(workdir, "multi_data")
    write_eval_boards(data, 160, args.seed + 22)
    env = {**os.environ, "PYTHONUNBUFFERED": "1"}
    ckpts = {}
    for how in ("plain", "launcher"):
        save = os.path.join(workdir, f"multi_{how}")
        cmd = (["-m", "chess_vision_tpu_torch.train"] if how == "plain" else
               ["-m", "torch.distributed.run", "--nproc-per-node", "1",
                "--nnodes", "1", "--master-addr", "localhost",
                "--master-port", str(dryrun.free_port()),
                "-m", "chess_vision_tpu_torch.train"])
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, *cmd, "--config", "configs/vit.yaml", "--set",
             "training.epochs=1", f"training.batch_size={TRAIN_BATCH}",
             "data.num_workers=4", "data.val_split=0.2", f"data.train_dir={data}",
             "data.ood_val_dir=", "model.pretrained=false", "model.remat=false",
             "model.depth=2",
             f"checkpointing.save_dir={save}",
             f"logging.tensorboard_dir={save}/runs"],
            cwd=root, env=env, capture_output=True, text=True, timeout=600)
        require(r.returncode == 0, f"{tag} {how} trainer exit {r.returncode}: "
                                   f"{r.stdout[-1500:]} {r.stderr[-2000:]}")
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith(("Devices", "Mesh", "  Train"))]
        print(f"{tag} {how} trainer ({time.perf_counter() - t0:.1f} s): "
              f"{lines}", flush=True)
        if how == "launcher":
            require("Mesh" in r.stdout and "nccl" in r.stdout,
                    f"{tag} the launcher run joined no NCCL group: {lines}")
        ckpts[how] = load_checkpoint(os.path.join(save, "latest.ckpt"))
    a, b = (flat_params(ckpts[h]["params"]) for h in ("plain", "launcher"))
    same = a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    gap = max(float(np.abs(a[k] - b[k]).max()) for k in a)
    lr = ckpts["plain"]["config"]["training"]["lr"]
    print(f"{tag} 1-rank NCCL group vs no group: checkpoints' {len(a)} "
          f"parameters bit-equal {same} (max |diff| {gap:.2e}; bound 2 lr "
          f"steps = {4 * lr:.1e}), steps {ckpts['plain']['step']} and "
          f"{ckpts['launcher']['step']}", flush=True)
    require(gap <= 4 * lr and ckpts["plain"]["step"] == ckpts["launcher"]["step"] == 2,
            f"{tag} the 1-rank group's checkpoint differs")

    # two ranks on cuda:0 over gloo, against one rank on the same card
    cfg = train_config("", remat=False)
    cfg["scheduler"]["warmup_epochs"] = 0
    batches = dryrun.random_batches(4, TRAIN_BATCH, size=SIZE, seed=args.seed)
    for batch in batches:
        batch["mask"][:] = 1.0
    t0 = time.perf_counter()
    ref = dryrun.train_steps(cfg, batches, device="cuda:0")
    ref_s = time.perf_counter() - t0
    runs = {"dp2": dict(cfg=cfg, batches=batches),
            "fsdp2": dict(cfg=cfg, batches=batches, fsdp=True),
            "tp2": dict(cfg=cfg, batches=batches, tp=2),
            # planted: no gradient sum over the data axis; must fail
            "dp2 unsummed": dict(cfg=cfg, batches=batches,
                                 plant="no_gradient_sum")}
    t0 = time.perf_counter()
    out = dryrun.compare_ranks(2, runs, device="cuda:0", backend="gloo")
    ranks_s = time.perf_counter() - t0
    lr, steps = cfg["training"]["lr"], len(batches)
    print(f"{tag} two ranks sharing one card over gloo (a check of the "
          f"function, not a scaling measurement): one rank {ref_s:.1f} s, the "
          f"four two-rank runs {ranks_s:.1f} s with start-up; one rank's "
          f"losses {[round(x, 5) for x in ref['losses']]}", flush=True)
    for name, res in out.items():
        first_gap = abs(res["losses"][0] - ref["losses"][0])
        loss_gap = max(abs(x - y) / abs(y) for x, y in zip(res["losses"],
                                                           ref["losses"]))
        diffs = torch.cat([(res["state"][k] - ref["state"][k]).abs().flatten()
                           for k in ref["state"]])
        p99 = diffs.float()[::7].quantile(0.99).item()
        launches = res["launches_by_rank"]
        print(f"{tag} {name}: losses {[round(x, 5) for x in res['losses']]} "
              f"(first step {first_gap:.2e} apart, atol {TRAIN_LOSS_ATOL}; "
              f"worst step {loss_gap:.2e} relative, rtol {MULTI_LOSS_RTOL}); "
              f"parameters max |diff| {diffs.max().item():.2e} (bound 2 lr "
              f"steps = {2 * lr * steps:.1e}), 99th percentile {p99:.2e} "
              f"(bound {MULTI_P99}); (K2, K3, f32 K2, f32 K3) launches by "
              f"rank {launches}", flush=True)
        same = (first_gap <= TRAIN_LOSS_ATOL and loss_gap <= MULTI_LOSS_RTOL
                and diffs.max().item() <= 2 * lr * steps and p99 <= MULTI_P99)
        if "plant" in runs[name]:
            require(not same, f"{tag} the planted fault ({name}) passes the "
                              "bounds of two ranks against one")
            continue
        require(same, f"{tag} {name} differs from one rank")
        require(all(c[:2] == [12 * steps, 12 * steps] for c in launches),
                f"{tag} {name} launches by rank {launches}")
    torch.cuda.empty_cache()

    # the graft entry's three surfaces, as a user runs them on the card
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "chess_vision_tpu_torch.parallel.dryrun", "2"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    lines = [ln for ln in r.stdout.splitlines() if "dryrun_multichip" in ln]
    print(f"{tag} python -m chess_vision_tpu_torch.parallel.dryrun 2 "
          f"({time.perf_counter() - t0:.1f} s): {lines}", flush=True)
    require(r.returncode == 0 and len(lines) == 3 and "cuda" in lines[0],
            f"{tag} dryrun exit {r.returncode}: {r.stdout[-1500:]} "
            f"{r.stderr[-2000:]}")
    print(f"{tag} {kind}, {smi}; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def flat_params(params: dict) -> dict:
    """A checkpoint's parameter tree flattened to path -> array."""
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{path}/{k}")
            else:
                out[f"{path}/{k}"] = np.asarray(v)

    walk(params, "")
    return out


def dp_phase(args, cfg, params, boards, train_ckpt: str, workdir: str,
             kind: str, smi: str) -> None:
    """Phase 23: serving and evaluation over two replicas on the one card."""
    import io
    from contextlib import redirect_stdout

    import torch

    from chess_vision_tpu_torch import evaluate as ev
    from chess_vision_tpu_torch.config import get_data_config
    from chess_vision_tpu_torch.data import BatchLoader, ChessDataset
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import preprocess as pre_ops
    from chess_vision_tpu_torch.serve import Predictor

    tag = "[23 dp]"
    t_phase = time.perf_counter()
    two = ["cuda:0", "cuda:0"]
    depth = cfg["model"]["depth"]
    batches = math.ceil(len(boards) / BATCH)
    one = Predictor((cfg, params), batch_size=BATCH, device="cuda")
    dp = Predictor((cfg, params), batch_size=BATCH, devices=two)
    fens_one = one.predict_array(boards)
    dp.predict_array(boards[:BATCH])
    reset_counts()
    fens_dp = dp.predict_array(boards)
    counts = (pre_ops.LAUNCHES, attn_ops.LAUNCHES)
    rates = {}
    for name, p in (("one", one), ("two", dp), ("two", dp), ("one", one)):
        t0 = time.perf_counter()
        p.predict_array(boards)
        rates.setdefault(name, []).append(len(boards) / (time.perf_counter() - t0))
    print(f"{tag} bf16 Predictor(devices={two}): (K1, K2) launches {counts} for "
          f"{batches} batches of 2 shards; FENs equal to one device's "
          f"{sum(a == b for a, b in zip(fens_dp, fens_one))}/{len(boards)}; "
          f"boards/s in turns {rates} (two replicas on one card)", flush=True)
    require(counts == (2 * batches, 2 * depth * batches), f"{tag} launches {counts}")
    require(fens_dp == fens_one, f"{tag} bf16 FENs differ from one device's")
    del one, dp

    int8_one, _ = build_int8_predictor(args, cfg, params, "block")
    int8_dp, _ = build_int8_predictor(args, cfg, params, "block", devices=two)
    fens_one = int8_one.predict_array(boards)
    reset_counts()
    fens_dp = int8_dp.predict_array(boards)
    got = int8_counts()
    want = int8_want("block", depth, 2 * batches)
    print(f"{tag} int8 block Predictor(devices={two}): launches {got}; FENs "
          f"equal to one device's {sum(a == b for a, b in zip(fens_dp, fens_one))}"
          f"/{len(boards)}; shifts shared "
          f"{int8_dp.attn_shifts == int8_one.attn_shifts}", flush=True)
    require(got == want, f"{tag} int8 launches {got}, want {want}")
    require(fens_dp == fens_one, f"{tag} int8 FENs differ from one device's")
    del int8_one, int8_dp
    torch.cuda.empty_cache()

    # the serve CLI with --dp on the card, against it without
    root = os.path.dirname(os.path.abspath(__file__))
    test_dir = os.path.join(workdir, "eval")
    images = os.path.join(test_dir, "00000*.jpg")
    outs = {}
    for flag in ("--dp", "--device=cuda"):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "chess_vision_tpu_torch.serve",
             "--checkpoint", train_ckpt, "--images", images, "--batch-size", "8",
             flag], cwd=root, env={**os.environ, "PYTHONUNBUFFERED": "1"},
            capture_output=True, text=True, timeout=600)
        require(r.returncode == 0, f"{tag} serve {flag} exit {r.returncode}: "
                                   f"{r.stderr[-2000:]}")
        outs[flag] = r.stdout
        print(f"{tag} python -m chess_vision_tpu_torch.serve {flag} "
              f"({time.perf_counter() - t0:.1f} s): "
              f"{r.stderr.strip().splitlines()[-2:]}", flush=True)
    require(outs["--dp"] == outs["--device=cuda"] and outs["--dp"].count("\n") == 10,
            f"{tag} serve --dp printed {outs['--dp'][:500]}")

    # evaluate over two replicas on phase 17's boards, against one device
    model = Predictor((cfg, params), batch_size=BATCH, device="cuda").model
    data_cfg = get_data_config(cfg["model"]["name"])
    dataset = ChessDataset(test_dir, input_size=SIZE)
    reports = []
    for devices in (None, two):
        loader = BatchLoader(dataset, np.arange(len(dataset)), BATCH,
                             num_workers=8)
        text = io.StringIO()
        with redirect_stdout(text):
            metrics = ev.evaluate(model, dataset, loader, data_cfg["mean"],
                                  data_cfg["std"], devices=devices)
        reports.append((metrics, text.getvalue()))
    (one_m, one_text), (two_m, two_text) = reports
    loss_gap = abs(two_m["loss"] - one_m["loss"]) / max(abs(one_m["loss"]), 1e-30)
    print(f"{tag} evaluate over {two}: metrics {two_m}; report text equal to "
          f"one device's {two_text == one_text}; the mean loss (the shards' "
          f"sums added) {loss_gap:.1e} apart; {kind}, {smi}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    require(two_text == one_text and loss_gap <= 1e-6
            and all(two_m[k] == one_m[k] for k in one_m if k != "loss"),
            f"{tag} the two-replica evaluation differs")

def long_counts() -> tuple[int, int, int, int, int, int]:
    """(K2, K3, K3 on the long route) in bf16, then the same in f32."""
    from chess_vision_tpu_torch.ops import attention as attn_ops

    return (attn_ops.LAUNCHES, attn_ops.BWD_LAUNCHES, attn_ops.BWD_LONG_LAUNCHES,
            attn_ops.F32_LAUNCHES, attn_ops.F32_BWD_LAUNCHES,
            attn_ops.F32_BWD_LONG_LAUNCHES)


def vit_train_run(tag: str, args, corpus, batch: int, f32: bool, workdir: str,
                  kind: str, smi: str, write_checkpoint: bool = True,
                  **model) -> int:
    """``train()`` for one epoch on ``corpus`` (``configs/vit.yaml`` values
    with ``model`` overrides, remat off): every train step must launch K2
    and K3 once a block, K3 on the route ``bwd_route`` gives the model's
    tokens and head dim, every eval step K2 alone; finite losses; warm
    img/s and peak memory printed. ``write_checkpoint`` False leaves out the
    epoch's checkpoint (several GB at ViT-Huge's widths). Returns the run's K2
    and K3 launches."""
    import torch

    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.train import __main__ as trainer

    save_dir = os.path.join(workdir, f"run_{'f32' if f32 else 'bf16'}")
    cfg = train_config(save_dir, input_size=corpus.input_size, remat=False,
                       **model)
    cfg["training"].update(epochs=1, batch_size=batch, mixed_precision=not f32)
    depth, heads = cfg["model"]["depth"], cfg["model"]["num_heads"]
    n = (corpus.input_size // 16) ** 2 + 1
    route = attn_ops.bwd_route(n, torch.float32 if f32 else torch.bfloat16,
                               cfg["model"]["embed_dim"] // heads)
    per_step = []

    def on_step(step_kind, sums):
        torch.cuda.synchronize()
        per_step.append((step_kind, long_counts(), time.perf_counter(),
                         float(sums.get("step_loss", sums["loss_sum"]))))
        reset_counts()

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with ExitStack() as stack:
        if not write_checkpoint:
            stack.enter_context(mock.patch.object(
                trainer, "save_checkpoint", lambda *a, **k: None))
        try:
            result = trainer.train(cfg, corpus, seed=args.seed, device="cuda",
                                   on_step=on_step)
            torch.cuda.synchronize()
        finally:
            shutil.rmtree(save_dir, ignore_errors=True)
    train_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    del result
    torch.cuda.empty_cache()
    # (K2, K3, K3 long) of the step's precision
    counts = {k: sorted({s[1][3:] if f32 else s[1][:3] for s in per_step
                         if s[0] == k}) for k in ("train", "eval")}
    other = sorted({s[1][:3] if f32 else s[1][3:] for s in per_step})
    losses = [s[3] for s in per_step if s[0] == "train"]
    gaps = [b[2] - a[2] for a, b in zip(per_step, per_step[1:])
            if a[0] == b[0] == "train"]
    warm = batch * len(gaps) / sum(gaps) if gaps else float("nan")
    m = cfg["model"]
    print(f"{tag} ViT {m['embed_dim']} wide, {depth} blocks, {heads} heads of "
          f"{m['embed_dim'] // heads}, {corpus.input_size}px "
          f"{'f32' if f32 else 'bf16'}, batch {batch}, remat off: "
          f"{len(losses)} train steps in {train_s:.1f} s (evaluation "
          f"included, checkpoint {'written' if write_checkpoint else 'left out'}"
          f"); (K2, K3, K3 on {route}) per step {counts}, the other "
          f"precision's {other}; step losses {[round(x, 4) for x in losses]}; "
          f"warm train img/s {warm:.1f} ({len(gaps)} step intervals); peak "
          f"device memory {peak_gib:.2f} GiB; {kind}, {smi}", flush=True)
    steps = len(corpus) * 4 // 5 // batch
    require(len(losses) == steps and all(math.isfinite(x) for x in losses),
            f"{tag} train step losses {losses}")
    long = depth if route in ("long", "f32_long") else 0
    require(counts == {"train": [(depth, depth, long)], "eval": [(depth, 0, 0)]}
            and other == [(0, 0, 0)], f"{tag} launches per step {counts}, {other}")
    return (sum(s[1][3 if f32 else 0] for s in per_step),
            sum(s[1][4 if f32 else 1] for s in per_step))


def vit_grads_check(tag: str, args, corpus, batch: int, f32: bool,
                    **model) -> tuple:
    """One train step with dropout and drop path off and fixed augmentation
    draws, through the kernels and through plain attention on the same
    weights: loss and per-tensor gradients within the bounds of phase 11
    (bf16) or 20 (f32); the kernel step launches K2 and K3 once a block.
    Returns the kernel step's ``long_counts()``."""
    import torch

    from chess_vision_tpu_torch.augment import draw_params
    from chess_vision_tpu_torch.ops import attention as attn_ops

    dev = torch.device("cuda")
    quiet = train_config("", input_size=corpus.input_size, head_dropout=0.0,
                         drop_path_rate=0.0, remat=False, **model)
    quiet["training"]["mixed_precision"] = not f32
    quiet["scheduler"]["warmup_epochs"] = 0  # lr(0) is the base rate
    state, step, _, batches = make_trainer(quiet, corpus, args.seed, batch=batch)
    aug = draw_params(batch, torch.Generator(device=dev).manual_seed(args.seed))
    reset_counts()
    grads_k, loss_k = step_with_grads(state, step, batches[0], aug, update=False)
    moved = long_counts()
    with plain_attention():
        grads_p, loss_p = step_with_grads(state, step, batches[0], aug,
                                          update=False)
    require(long_counts() == moved, f"{tag} the plain step launched a kernel")
    depth, heads = quiet["model"]["depth"], quiet["model"]["num_heads"]
    route = attn_ops.bwd_route((corpus.input_size // 16) ** 2 + 1,
                               torch.float32 if f32 else torch.bfloat16,
                               quiet["model"]["embed_dim"] // heads)
    want = (depth, depth, depth if route in ("long", "f32_long") else 0)
    require(moved == ((0, 0, 0) + want if f32 else want + (0, 0, 0)),
            f"{tag} the kernel step's launches {moved}")
    worst, name, _ = grad_gap(grads_k, grads_p)
    bound = F32_GRAD_RTOL if f32 else TRAIN_GRAD_RTOL
    loss_ok = (abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) if f32
               else abs(loss_k - loss_p) <= TRAIN_LOSS_ATOL)
    print(f"{tag} one {'f32' if f32 else 'bf16'} step at batch {batch}, kernels "
          f"vs plain attention on the card: loss {loss_k} vs {loss_p}; worst "
          f"per-tensor max |grad diff| / max |grad| {worst:.3e} at {name} "
          f"(bound {bound}); launches {moved}", flush=True)
    require(math.isfinite(loss_k) and loss_ok, f"{tag} losses {loss_k}, {loss_p}")
    require(all(torch.isfinite(g).all() for g in grads_k.values()),
            f"{tag} a kernel-path gradient is not finite")
    require(worst <= bound, f"{tag} gradient of {name}: {worst}")
    del state, step, grads_k, grads_p, batches
    torch.cuda.empty_cache()
    return moved


def p384_run(tag: str, args, corpus, batch: int, f32: bool, workdir: str,
             kind: str, smi: str) -> int:
    """Phase 24, one precision: ``train()`` for one epoch of 4 steps at
    input_size 384 (launches counted a step, every K3 on the long route),
    then one step through the kernels against one through plain attention.
    Returns the long route's launches in the ``train()`` run."""
    launches = vit_train_run(tag, args, corpus, batch, f32, workdir, kind, smi)[1]
    vit_grads_check(tag, args, corpus, batch, f32)
    return launches


def p384_phase(args, kernels: dict, kind: str, smi: str, workdir: str) -> None:
    """Phase 24: ViT-B/16 trained at input_size 384 (577 tokens), where K3
    takes its long routes: bf16 at batch 64, f32 at batch 16."""
    tag = "[24 p384]"
    t_phase = time.perf_counter()
    size = 384
    kernels["fused_qkv_attention_bwd_long"]["launches"] += p384_run(
        tag, args, MemoryCorpus(320, args.seed, size), TRAIN_BATCH, False,
        workdir, kind, smi)
    kernels["fused_qkv_attention_bwd_f32_long"]["launches"] += p384_run(
        tag, args, MemoryCorpus(80, args.seed, size), 16, True, workdir, kind,
        smi)
    print(f"{tag} phase {time.perf_counter() - t_phase:.1f} s", flush=True)


# ViT-Huge's widths (Dosovitskiy et al., 2021, Table 1): width 1280, MLP
# 5120, 16 heads of 80, its 32 blocks cut to 16 to keep the script's time
# under ~700 s; and ViT-B/16's widths on 6 heads of 128
HUGE = {"embed_dim": 1280, "depth": 16, "num_heads": 16}
HEADS_128 = {"num_heads": 6}


def timm_vit_sd(seed: int, size: int = 224) -> dict:
    """A random timm-layout ViT-B/16 backbone ``state_dict`` at ``size`` px
    (14 x 14 positions at 224): the port's own backbone, whose names and
    layouts are timm's, initialized from ``seed``."""
    from chess_vision_tpu_torch.models import build_model, init_weights

    model = init_weights(build_model(
        {"model": {**FULL_WIDTH, "input_size": size},
         "training": {"mixed_precision": False}}), seed=seed)
    return {k[len("backbone."):]: v for k, v in model.state_dict().items()
            if k.startswith("backbone.")}


def pth_weights(args, workdir: str, kind: str, smi: str) -> None:
    """Phase 25 (a): a timm ``.pth`` through ``model.pretrained_path`` into
    ``train()``, a reference ``.pth`` through the converter's CLI into
    ``Predictor``, and a ``.pth`` missing one tensor refused."""
    import torch

    from chess_vision_tpu_torch.convert import timm as tconv
    from chess_vision_tpu_torch.convert.jax_params import variables_from_state_dict
    from chess_vision_tpu_torch.models import build_model, init_weights
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.serve import Predictor
    from chess_vision_tpu_torch.train import __main__ as trainer

    tag = "[25a pth]"
    sd = timm_vit_sd(args.seed)
    pth = os.path.join(workdir, "vit_base_patch16_224.pth")
    torch.save(sd, pth)
    want = tconv.backbone_state_dict(sd, "vit", SIZE)
    loaded = {}
    original = trainer.maybe_load_pretrained

    def checked(model, cfg):  # the backbone as the first step will find it
        ok = original(model, cfg)
        got = model.state_dict()
        loaded["equal"] = ok and all(torch.equal(got[k], v) for k, v in want.items())
        loaded["pos_embed"] = tuple(got["backbone.pos_embed"].shape)
        return ok

    corpus = MemoryCorpus(160, args.seed)
    with mock.patch.object(trainer, "maybe_load_pretrained", checked):
        launches = vit_train_run(tag, args, corpus, TRAIN_BATCH, False, workdir,
                                 kind, smi, pretrained=True, pretrained_path=pth)
    print(f"{tag} train() from a timm .pth at 224 px: backbone before the "
          f"first step equal to backbone_state_dict's bit for bit "
          f"{loaded.get('equal')}, pos_embed {loaded.get('pos_embed')}; (K2, "
          f"K3) launches {launches}", flush=True)
    require(loaded.get("equal") and loaded["pos_embed"] == (1, 257, 768),
            f"{tag} the loaded backbone: {loaded}")

    # a reference training checkpoint through the CLI, served
    cfg = {"model": dict(FULL_WIDTH), "training": {"mixed_precision": True}}
    model_sd = init_weights(build_model(cfg), seed=args.seed + 1).state_dict()
    ref = os.path.join(workdir, "best.pth")
    torch.save({"model": {**model_sd, "class_to_type": torch.arange(13)},
                "config": cfg, "epoch": 3, "best_val_acc": 0.5}, ref)
    out = os.path.join(workdir, "converted.ckpt")
    root = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-m", "chess_vision_tpu_torch.convert.timm",
                        "--reference-ckpt", ref, "--out", out], cwd=root,
                       capture_output=True, text=True, timeout=300)
    require(r.returncode == 0, f"{tag} converter exit {r.returncode}: "
                               f"{r.stderr[-2000:]}")
    boards = np.random.default_rng(args.seed + 25).integers(
        0, 256, (args.boards, SIZE, SIZE, 3), dtype=np.uint8)
    attn_ops.LAUNCHES = 0
    fens = Predictor(out, batch_size=BATCH, device="cuda").predict_array(boards)
    served = attn_ops.LAUNCHES
    straight = Predictor((cfg, variables_from_state_dict(model_sd)["params"]),
                         batch_size=BATCH, device="cuda").predict_array(boards)
    same = sum(a == b for a, b in zip(fens, straight))
    print(f"{tag} reference .pth -> CLI -> Predictor: {same}/{len(boards)} FENs "
          f"equal to the same weights loaded straight; K2 launches {served}",
          flush=True)
    require(same == len(boards) == len(fens) and served > 0,
            f"{tag} converted reference FENs: {same}/{len(boards)}")

    # planted: one tensor taken out of the .pth
    partial = os.path.join(workdir, "partial.pth")
    torch.save({k: v for k, v in sd.items() if k != "blocks.3.attn.qkv.weight"},
               partial)
    pcfg = train_config("", pretrained=True, pretrained_path=partial)
    try:
        trainer.maybe_load_pretrained(build_model(pcfg), pcfg)
        refused = "loaded"
    except ValueError as err:
        refused = str(err)
    print(f"{tag} planted: a .pth without blocks.3.attn.qkv.weight -> {refused}",
          flush=True)
    require("blocks.3.attn.qkv.weight" in refused, f"{tag} the partial .pth loaded")
    torch.cuda.empty_cache()


def head_dim_kernels(args, dev, kernels: dict) -> None:
    """Phase 25 (b): K2 and K3, bf16 and f32, at head dims 80 (16 heads,
    ViT-Huge) and 128 (6 heads, ViT-B/16's width) at (64, 257, 3 D), and the
    long routes at (16, 577, 3 D): each against its plain version within
    the bound it keeps at 64, every backward twice bit-identical; times by
    CUDA events beside plain and SDPA's; routes, plans, ptxas's counts. The
    (64, 257) readings become the kernels line's entries at these head dims
    (their launches counted by (c) and (d))."""
    import torch

    from chess_vision_tpu_torch.ops import attention as attn_ops

    tag = "[25b head dims]"
    gen = torch.Generator(device=dev).manual_seed(args.seed + 25)
    for dh, heads in ((80, HUGE["num_heads"]), (128, HEADS_128["num_heads"])):
        for B, n in ((TRAIN_BATCH, SIZE // 16 * SIZE // 16 + 1), (16, 577)):
            for dtype in (torch.bfloat16, torch.float32):
                f32 = dtype == torch.float32
                D = heads * dh
                qkv = torch.randn((B, n, 3 * D), device=dev, generator=gen).to(dtype)
                g = torch.randn((B, n, D), device=dev, generator=gen).to(dtype)
                out = attn_ops.fused_qkv_attention_fwd(qkv, heads)
                dqkv = attn_ops.fused_qkv_attention_bwd(qkv, g, heads)
                again = attn_ops.fused_qkv_attention_bwd(qkv, g, heads)
                ref = attn_ops.reference_attention(qkv, heads)
                dref = attn_ops.reference_attention_bwd(qkv, g, heads)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                derr = (dqkv.float() - dref.float()).abs().max().item()
                same = torch.equal(dqkv, again)
                del ref, dref, again, out, dqkv
                fwd_bound = F32_ATOL if f32 else ATTN_ATOL
                bwd_bound = F32_ATOL if f32 else K3_ATOL
                ms = cuda_ms(lambda: attn_ops.fused_qkv_attention_fwd(qkv, heads), 5)
                bwd_ms = cuda_ms(
                    lambda: attn_ops.fused_qkv_attention_bwd(qkv, g, heads), 5)
                plain_ms = cuda_ms(lambda: attn_ops.reference_attention(qkv, heads), 2)
                plain_bwd = cuda_ms(
                    lambda: attn_ops.reference_attention_bwd(qkv, g, heads), 2)
                lib_fwd, lib_bwd = sdpa_ms(qkv, g, heads)
                route = attn_ops.bwd_route(n, dtype, dh)
                plan = (attn_ops.long_plan(n, dtype, dh) if "long" in route
                        else attn_ops.f32_plan(n, True, dh))
                size = 4 if f32 else 2
                ops = 2 * 2 * B * heads * n * n * dh
                op_type = "f32" if f32 else "bf16"
                fwd_entry = kernel_entry(
                    "", "attention_f32.cu" if f32 else "attention.cu",
                    "chess_vision_tpu/ops/attention.py:90", err, ms, plain_ms,
                    nbytes=size * qkv.numel() * 4 // 3, ops=ops,
                    op_type=op_type, library_ms=lib_fwd)
                bwd_entry = kernel_entry(
                    "", "attention_f32.cu" if f32 else "attention_bwd_cluster.cu",
                    "chess_vision_tpu/ops/attention.py:623", derr, bwd_ms,
                    plain_bwd, nbytes=size * (2 * qkv.numel() + g.numel()),
                    ops=ops * 5 // 2, op_type=op_type, library_ms=lib_bwd)
                mode = {"long": 0, "f32": 0, "f32_long": 1 if plan[0] == 1 else 3}
                fwd_kernel = "attention_fwd_f32_kernel" if f32 else "attention_fwd_kernel"
                bwd_kernel = ("attention_bwd_f32_kernel" if f32
                              else "attention_bwd_cluster_kernel")
                warps = plan[2] if "long" in route else 4
                smem = attn_ops.long_smem_bytes(dh, warps, dtype)
                ld = dh + 4  # the f32 forward's layout (attention_f32.cuh)
                fwd_smem = (4 * (3 * 64 * ld + max(64 * 72, 64 * dh) + 640 + 576)
                            if f32 else 2 * (2 * 2 * 64 + 96) * (dh + 8))
                print(f"{tag} {op_type} {tuple(qkv.shape)} {heads} heads of {dh}: "
                      f"K2 max |diff| {err} (bound {fwd_bound}), {ms:.4f} ms "
                      f"(bound {fwd_entry['bound_ms']:.4f}, plain {plain_ms:.4f}, "
                      f"SDPA {lib_fwd:.4f}; {ptxas_counts(fwd_kernel, dh)}, "
                      f"{fwd_smem} bytes of shared memory a block); K3 on "
                      f"{route} plan {plan}: max |diff| {derr} (bound {bwd_bound}), "
                      f"twice bit-identical {same}, {bwd_ms:.4f} ms (bound "
                      f"{bwd_entry['bound_ms']:.4f}, plain {plain_bwd:.4f}, SDPA "
                      f"backward {lib_bwd:.4f}; "
                      f"{ptxas_counts(bwd_kernel, dh, mode[route])}, {smem} "
                      "bytes of shared memory a CTA)",
                      flush=True)
                require(err <= fwd_bound and derr <= bwd_bound and same,
                        f"{tag} {op_type} at {tuple(qkv.shape)}, head dim {dh}: "
                        f"{err}, {derr}, deterministic {same}")
                if n == 257:
                    suffix = f"{'_f32' if f32 else ''}_dh{dh}"
                    for name, entry in ((f"fused_qkv_attention{suffix}", fwd_entry),
                                        (f"fused_qkv_attention_bwd{suffix}"
                                         if f32 else
                                         f"fused_qkv_attention_bwd_long_dh{dh}",
                                         bwd_entry)):
                        if dh == 128 and f32:
                            continue  # no main path trains ViT-B widths on 6 heads in f32
                        entry["name"] = name
                        kernels[name] = entry
                del qkv, g
                torch.cuda.empty_cache()


def huge_phase(args, kernels: dict, kind: str, smi: str, workdir: str) -> None:
    """Phase 25 (c): ViT-Huge's widths at 256 px (257 tokens, 16 heads of
    80) with random weights: bf16 serving held to plain, ``train()`` in bf16,
    and an f32 step against plain."""
    import torch

    from chess_vision_tpu_torch.experiments.plain import forward_logits
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import preprocess as pre_ops
    from chess_vision_tpu_torch.serve import Predictor

    tag = "[25c ViT-Huge]"
    depth = HUGE["depth"]
    cfg = {"model": {**FULL_WIDTH, **HUGE}, "training": {"mixed_precision": True}}
    t0 = time.perf_counter()
    predictor = Predictor((cfg, random_jax_params(cfg, args.seed)),
                          batch_size=BATCH, device="cuda")
    params = sum(p.numel() for p in predictor.model.parameters())
    boards = np.random.default_rng(args.seed + 26).integers(
        0, 256, (args.boards, SIZE, SIZE, 3), dtype=np.uint8)
    predictor.predict_array(boards[:BATCH])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    fens = predictor.predict_array(boards)
    serve_s = time.perf_counter() - t0
    served = attn_ops.LAUNCHES
    batches = math.ceil(args.boards / BATCH)
    with plain_ops(attn_ops, pre_ops):
        fens_plain = predictor.predict_array(boards)
    logits_k = forward_logits(predictor, boards)
    with plain_ops(attn_ops, pre_ops):
        logits_p = forward_logits(predictor, boards)
    print(f"{tag} {params:,} parameters; bf16 Predictor, {args.boards} boards in "
          f"{batches} batches of {BATCH}: K2 launches {served} ({depth} a batch "
          f"wanted), {args.boards / serve_s:.1f} boards/s; set-up {setup_s:.1f} s",
          flush=True)
    require(served == depth * batches, f"{tag} K2 launches {served}")
    require_logits(tag, fens, fens_plain, logits_k, logits_p, SQUARES_ULPS)
    kernels["fused_qkv_attention_dh80"]["launches"] += served
    del predictor
    torch.cuda.empty_cache()

    corpus = MemoryCorpus(320, args.seed)
    k2, k3 = vit_train_run(tag, args, corpus, TRAIN_BATCH, False, workdir, kind,
                           smi, write_checkpoint=False, **HUGE)
    kernels["fused_qkv_attention_dh80"]["launches"] += k2
    kernels["fused_qkv_attention_bwd_long_dh80"]["launches"] += k3
    vit_grads_check(tag, args, corpus, TRAIN_BATCH, False, **HUGE)
    moved = vit_grads_check(tag, args, MemoryCorpus(16, args.seed), 16, True,
                            **HUGE)
    kernels["fused_qkv_attention_f32_dh80"]["launches"] += moved[3]
    kernels["fused_qkv_attention_bwd_f32_dh80"]["launches"] += moved[4]


def head128_phase(args, kernels: dict, kind: str, smi: str, workdir: str) -> None:
    """Phase 25 (d): ``train()`` with ViT-B/16's widths on 6 heads of 128,
    bf16, batch 64, 2 steps: every K3 on the cluster route."""
    tag = "[25d heads of 128]"
    k2, k3 = vit_train_run(tag, args, MemoryCorpus(160, args.seed), TRAIN_BATCH,
                           False, workdir, kind, smi, **HEADS_128)
    kernels["fused_qkv_attention_dh128"]["launches"] += k2
    kernels["fused_qkv_attention_bwd_long_dh128"]["launches"] += k3


def head_dims_phase(args, kernels: dict, kind: str, smi: str, workdir: str) -> None:
    """Phase 25: weights from .pth, K2 and K3 at head dims 80 and 128,
    ViT-Huge's widths, and ViT-B/16's widths on heads of 128."""
    import torch

    t_phase = time.perf_counter()
    pth_weights(args, workdir, kind, smi)
    head_dim_kernels(args, torch.device("cuda"), kernels)
    huge_phase(args, kernels, kind, smi, workdir)
    head128_phase(args, kernels, kind, smi, workdir)
    print(f"[25 head dims] phase {time.perf_counter() - t_phase:.1f} s", flush=True)



# ViT-B/16's widths on 3 heads of 256 and on 64 heads of 12: head dims that
# only the any-head-dim kernels (csrc/attention_any.cu) run
HEADS_256 = {"num_heads": 3}
HEADS_12 = {"num_heads": 64}
ANY_HEAD_DIMS = (1, 3, 12, 20, 36, 100, 136, 192, 256, 384, 768, 1024, 1100)


def any_counts() -> tuple[int, int]:
    from chess_vision_tpu_torch.ops import attention as attn_ops

    return attn_ops.ANY_LAUNCHES, attn_ops.ANY_BWD_LAUNCHES


def any_check(tag: str, dev, gen, B: int, n: int, heads: int, dh: int, dtype
              ) -> tuple:
    """K2 and K3 on the any-head-dim kernels at (B, n, 3 heads dh) against
    their plain versions within head dim 64's bounds, the backward twice
    bit-identical, one launch of each counted in the dtype's counter and in
    the any-head-dim ones. K2 is held to the plain forward on f32 copies of
    the inputs: in bf16 the plain forward rounds the scores to bf16, as the
    JAX package's reference does, where the kernels (and the JAX kernel)
    keep them in f32, and at 64 heads of 12 and batch 64 that rounding alone
    can put it more than the bound from the exact result. In bf16 the line
    also gives K2's distance from the bf16 plain forward and the distances
    of the two plain forwards and K2 from the exact result (f64). The plain backward keeps the kernels'
    rounding points in either dtype. Returns (qkv, g, fwd err, bwd err)."""
    import torch

    from chess_vision_tpu_torch.ops import attention as attn_ops

    f32 = dtype == torch.float32
    D = heads * dh
    qkv = torch.randn((B, n, 3 * D), device=dev, generator=gen).to(dtype)
    g = torch.randn((B, n, D), device=dev, generator=gen).to(dtype)
    before = long_counts() + any_counts()
    out = attn_ops.fused_qkv_attention_fwd(qkv, heads)
    dqkv = attn_ops.fused_qkv_attention_bwd(qkv, g, heads)
    again = attn_ops.fused_qkv_attention_bwd(qkv, g, heads)
    torch.cuda.synchronize()
    moved = tuple(a - b for a, b in zip(long_counts() + any_counts(), before))
    ref = attn_ops.reference_attention(qkv.float(), heads)
    err = (out.float() - ref).abs().max().item()
    derr = (dqkv.float() - attn_ops.reference_attention_bwd(qkv, g, heads).float()
            ).abs().max().item()
    same = torch.equal(dqkv, again)
    finite = bool(torch.isfinite(out).all() and torch.isfinite(dqkv).all())
    want = (0, 0, 0, 1, 2, 0, 1, 2) if f32 else (1, 2, 0, 0, 0, 0, 1, 2)
    fwd_bound = F32_ATOL if f32 else ATTN_ATOL
    bwd_bound = F32_ATOL if f32 else K3_ATOL
    against = ""
    if not f32:
        exact = attn_ops.reference_attention(qkv.double(), heads)
        plain = attn_ops.reference_attention(qkv, heads).double()
        against = (f"; {(out.double() - plain).abs().max().item():.3e} from the bf16 plain "
                   f"forward; from the exact result the bf16 plain "
                   f"{(plain - exact).abs().max().item():.3e}, the f32 plain "
                   f"{(ref.double() - exact).abs().max().item():.3e}, K2 "
                   f"{(out.double() - exact).abs().max().item():.3e}")
        del exact, plain
    del ref
    print(f"  {tag} {'f32' if f32 else 'bf16'} {tuple(qkv.shape)} {heads} heads "
          f"of {dh} (chunks, columns {attn_ops.any_plan(dh)}; backward clusters, "
          f"CTAs, keys {attn_ops.any_bwd_plan(n, dh)}): K2 max |diff| {err:.3e} "
          f"(bound {fwd_bound}){against}; K3 {derr:.3e} (bound {bwd_bound}), twice "
          f"bit-identical {same}, launches {moved}", flush=True)
    require(finite and err <= fwd_bound and derr <= bwd_bound and same
            and moved == want,
            f"{tag} {'f32' if f32 else 'bf16'} at {tuple(qkv.shape)}, head dim "
            f"{dh}: {err}, {derr}, deterministic {same}, finite {finite}, "
            f"launches {moved}")
    return qkv, g, err, derr


def any_kernel_checks(args, dev, kernels: dict) -> None:
    """Phase 26 (a): the any-head-dim kernels at every head dim of
    ``ANY_HEAD_DIMS`` and, at 12, 256 and 1,024, at 577 and 1,100 tokens; then
    timed at (64, 257, 2304) on 3 heads of 256 and on 64 heads of 12,
    whose readings become the kernels line's entries (their launches
    counted by (b) and (c))."""
    import re

    import torch

    from chess_vision_tpu_torch.ops import _build
    from chess_vision_tpu_torch.ops import attention as attn_ops

    tag = "[26a any head dim]"
    gen = torch.Generator(device=dev).manual_seed(args.seed + 26)
    for dtype in (torch.bfloat16, torch.float32):
        for dh in ANY_HEAD_DIMS:
            any_check(tag, dev, gen, 2, 257, 2, dh, dtype)
        # ViT-L's width on one head of 1,024: the depth in windows, at 577
        # tokens in one backward launch and at 1,100 in three
        for dh, heads in ((12, HEADS_12["num_heads"]), (256, HEADS_256["num_heads"]),
                          (1024, 1)):
            for n in (577, 1100):
                any_check(tag, dev, gen, 2, n, heads, dh, dtype)
        torch.cuda.empty_cache()
    readings = []
    for block in _build.build_log.split("Compiling entry function '")[1:]:
        name = re.search(r"(any_(?:fwd|bwd|dq_sum)_kernel)I(\w*?)E", block.split("'")[0])
        spill = re.search(r"(\d+) bytes spill stores", block)
        regs = re.search(r"Used (\d+) registers", block)
        if name and spill and regs:
            mangled = block.split("'")[0]
            width = re.search(r"Li(\d+)E", mangled)
            # any_fwd_kernel<T, cols, whole-row copies, windowed depth>,
            # any_bwd_kernel<T, cols, windowed depth>
            flags = re.findall(r"Lb([01])E", mangled)
            fwd = name.group(1) == "any_fwd_kernel"
            whole = fwd and flags[:1] == ["1"]
            deep = (flags[1:2] if fwd else flags[:1]) == ["1"]
            readings.append(f"{name.group(1)} {'bf16' if 'bfloat16' in name.group(2) else 'f32'}"
                            f"{f' {width.group(1)}' if width else ''}"
                            f"{' whole-row copies' if whole else ''}"
                            f"{' windowed depth' if deep else ''}: "
                            f"{regs.group(1)}, {spill.group(1)}")
    print(f"  {tag} ptxas (kernel, dtype, output columns: registers, bytes "
          f"spilled): {'; '.join(readings) or 'not in this build log'}",
          flush=True)
    n = SIZE // 16 * SIZE // 16 + 1
    for dh, heads in ((256, HEADS_256["num_heads"]), (12, HEADS_12["num_heads"])):
        for dtype in (torch.bfloat16, torch.float32):
            f32 = dtype == torch.float32
            qkv, g, err, derr = any_check(tag, dev, gen, TRAIN_BATCH, n, heads,
                                          dh, dtype)
            ms = cuda_ms(lambda: attn_ops.fused_qkv_attention_fwd(qkv, heads), 5)
            bwd_ms = cuda_ms(
                lambda: attn_ops.fused_qkv_attention_bwd(qkv, g, heads), 5)
            plain_ms = cuda_ms(lambda: attn_ops.reference_attention(qkv, heads), 2)
            plain_bwd = cuda_ms(
                lambda: attn_ops.reference_attention_bwd(qkv, g, heads), 2)
            lib_fwd, lib_bwd = sdpa_ms(qkv, g, heads)
            size = 4 if f32 else 2
            ops = 2 * 2 * TRAIN_BATCH * heads * n * n * dh
            op_type = "f32" if f32 else "bf16"
            suffix = f"{'_f32' if f32 else ''}_any_dh{dh}"
            fwd_entry = kernel_entry(
                f"fused_qkv_attention{suffix}", "attention_any.cu",
                "chess_vision_tpu/ops/attention.py:90", err, ms, plain_ms,
                nbytes=size * qkv.numel() * 4 // 3, ops=ops, op_type=op_type,
                library_ms=lib_fwd)
            bwd_entry = kernel_entry(
                f"fused_qkv_attention_bwd{suffix}", "attention_any_bwd.cu",
                "chess_vision_tpu/ops/attention.py:623", derr, bwd_ms, plain_bwd,
                nbytes=size * (2 * qkv.numel() + g.numel()), ops=ops * 5 // 2,
                op_type=op_type, library_ms=lib_bwd)
            print(f"{tag} {op_type} {tuple(qkv.shape)} {heads} heads of {dh}: "
                  f"K2 {ms:.4f} ms (bound {fwd_entry['bound_ms']:.4f}, plain "
                  f"{plain_ms:.4f}, SDPA {lib_fwd:.4f}); K3 {bwd_ms:.4f} ms "
                  f"(bound {bwd_entry['bound_ms']:.4f}, plain {plain_bwd:.4f}, "
                  f"SDPA backward {lib_bwd:.4f})", flush=True)
            for entry in (fwd_entry, bwd_entry):
                kernels[entry["name"]] = entry
            del qkv, g
            torch.cuda.empty_cache()


def any_model_phase(tag: str, model: dict, args, kernels: dict, kind: str,
                    smi: str, workdir: str) -> None:
    """Phase 26 (b) and (c): ViT-B/16's widths on ``model``'s heads with
    random weights, every attention call an any-head-dim launch: bf16
    ``Predictor`` held to plain as phase 5, ``train()`` in bf16 at batch 64,
    one bf16 step at batch 64 and one f32 step at batch 16 against plain
    attention."""
    import torch

    from chess_vision_tpu_torch.experiments.plain import forward_logits
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import preprocess as pre_ops
    from chess_vision_tpu_torch.serve import Predictor

    cfg = {"model": {**FULL_WIDTH, **model}, "training": {"mixed_precision": True}}
    depth = cfg["model"]["depth"]
    dh = cfg["model"]["embed_dim"] // cfg["model"]["num_heads"]
    suffix = f"_any_dh{dh}"
    require(attn_ops.head_dim_route(dh) == "any", f"{tag} head dim {dh}'s route")
    predictor = Predictor((cfg, random_jax_params(cfg, args.seed)),
                          batch_size=BATCH, device="cuda")
    boards = np.random.default_rng(args.seed + 27).integers(
        0, 256, (args.boards, SIZE, SIZE, 3), dtype=np.uint8)
    predictor.predict_array(boards[:BATCH])
    torch.cuda.synchronize()
    reset_counts()
    attn_ops.ANY_LAUNCHES = attn_ops.ANY_BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    fens = predictor.predict_array(boards)
    serve_s = time.perf_counter() - t0
    served = (pre_ops.LAUNCHES, attn_ops.LAUNCHES, attn_ops.ANY_LAUNCHES)
    batches = math.ceil(args.boards / BATCH)
    with plain_ops(attn_ops, pre_ops):
        fens_plain = predictor.predict_array(boards)
        logits_p = forward_logits(predictor, boards)
    logits_k = forward_logits(predictor, boards)
    print(f"{tag} bf16 Predictor, {args.boards} boards in {batches} batches of "
          f"{BATCH}: (K1, K2, K2 on the any-head-dim kernel) launches {served} "
          f"({batches}, {depth * batches}, {depth * batches} wanted), "
          f"{args.boards / serve_s:.1f} boards/s; {kind}, {smi}", flush=True)
    require(served == (batches, depth * batches, depth * batches),
            f"{tag} serving launches {served}")
    require_logits(tag, fens, fens_plain, logits_k, logits_p, SQUARES_ULPS)
    kernels[f"fused_qkv_attention{suffix}"]["launches"] += served[2]
    del predictor
    torch.cuda.empty_cache()

    corpus = MemoryCorpus(320, args.seed)
    attn_ops.ANY_LAUNCHES = attn_ops.ANY_BWD_LAUNCHES = 0
    k2, k3 = vit_train_run(tag, args, corpus, TRAIN_BATCH, False, workdir, kind,
                           smi, write_checkpoint=False, **model)
    require(any_counts() == (k2, k3), f"{tag} train() launches ({k2}, {k3}), of "
                                      f"them on the any-head-dim kernels {any_counts()}")
    kernels[f"fused_qkv_attention{suffix}"]["launches"] += k2
    kernels[f"fused_qkv_attention_bwd{suffix}"]["launches"] += k3
    vit_grads_check(tag, args, corpus, TRAIN_BATCH, False, **model)
    attn_ops.ANY_LAUNCHES = attn_ops.ANY_BWD_LAUNCHES = 0
    moved = vit_grads_check(tag, args, MemoryCorpus(16, args.seed), 16, True,
                            **model)
    require(any_counts() == (moved[3], moved[4]),
            f"{tag} the f32 step's any-head-dim launches {any_counts()}")
    kernels[f"fused_qkv_attention_f32{suffix}"]["launches"] += moved[3]
    kernels[f"fused_qkv_attention_bwd_f32{suffix}"]["launches"] += moved[4]
    torch.cuda.empty_cache()


def any_head_dims_phase(args, kernels: dict, kind: str, smi: str,
                        workdir: str) -> None:
    """Phase 26: the any-head-dim kernels checked and timed, then ViT-B/16's
    widths on 3 heads of 256 and on 64 heads of 12 served and trained."""
    import torch

    t_phase = time.perf_counter()
    any_kernel_checks(args, torch.device("cuda"), kernels)
    any_model_phase("[26b heads of 256]", HEADS_256, args, kernels, kind, smi,
                    workdir)
    any_model_phase("[26c heads of 12]", HEADS_12, args, kernels, kind, smi,
                    workdir)
    print(f"[26 any head dim] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# Phase 27's Predictors, built without calibration boards, so every softmax
# takes its mode's shift: (tag, CHESS_VISION_INT8_LAYOUT, other variables).
MODE_PATHS = (
    ("block bound", "block", {}),
    ("flat bound", "flat", {}),
    ("fused bound", "fused", {}),
    ("block fixed", "block", {"CHESS_VISION_ATTN_SOFTMAX": "fixed"}),
    ("block max", "block", {"CHESS_VISION_ATTN_SOFTMAX": "max"}),
    ("block int8", "block", {"CHESS_VISION_ATTN_QK": "int8"}),
    ("block int8pv", "block", {"CHESS_VISION_ATTN_QK": "int8pv"}),
    ("block exp bf16", "block", {"CHESS_VISION_ATTN_EXP": "bf16"}),
    ("block epilogue bf16", "block", {"CHESS_VISION_EPILOGUE": "bf16"}),
    ("hybrid", "hybrid", {}),
    ("xla", "xla", {}),
)
# K4/K5 in each mode, as the quantizing attention's keywords
ATTN_MODES = (("bound", {}), ("fixed", {"shift_mode": "fixed"}),
              ("max", {"shift_mode": "max"}), ("exp bf16", {"exp_bf16": True}),
              ("int8", {"qk_int8": True}), ("pv only", {"pv_int8": True}),
              ("int8pv", {"qk_int8": True, "pv_int8": True}))


def attn_levels(q, s, rq_, rs) -> dict:
    """Quantizing attention, kernel vs plain: the largest code difference,
    the share of codes that differ, the dequantized difference in
    quantization steps of its row (``ATTN_LEVELS``) and the share of rows
    beyond that bound."""
    import torch

    diff = (q.int() - rq_.int()).abs()
    steps = ((q.float() * s - rq_.float() * rs).abs()
             / torch.maximum(s, rs)).amax(dim=-1)
    return {"levels": diff.max().item(), "flips": (diff > 0).float().mean().item(),
            "deq_levels": steps.max().item(),
            "rows_over": (steps > ATTN_LEVELS).float().mean().item(),
            "finite": bool(torch.isfinite(s).all())}


def attn_ok(w: dict, exp_bf16: bool) -> bool:
    """ATTN_LEVELS on every row, or with the bf16 exp on all but
    EXP_BF16_ROWS of them and EXP_BF16_LEVELS on those."""
    if exp_bf16:
        return (w["finite"] and w["rows_over"] <= EXP_BF16_ROWS
                and w["deq_levels"] <= EXP_BF16_LEVELS)
    return w["finite"] and w["deq_levels"] <= ATTN_LEVELS


def overshoot_qkv(qkv, H: int):
    """qkv with a bound that overshoots: image 0's keys of head 0 in the
    first 32 of their 64 columns, and its q rows 0-3 and 4-7 in the other 32,
    of norms that put |q| max_j |k_j| * scale at 115 and 200. Their scores are
    0, so the bound overshoots their max by 70 and 155: p = exp(-70) stays
    above the f32 flush line, exp(-155) does not (those rows' head 0 columns
    are zeros, as in the JAX kernel), and a bound without its -45 flushes
    rows 0-3 too (exp(-115))."""
    import torch

    out = qkv.clone()
    D = qkv.shape[-1] // 3
    out[0, :, D + 32:D + 64] = 0
    kmax = out[0, :, D:D + 64].float().square().sum(-1).max().sqrt().item()
    direction = torch.ones(32, device=qkv.device) / math.sqrt(32)
    for rows, target in ((slice(0, 4), 115.0), (slice(4, 8), 200.0)):
        out[0, rows, :64] = 0
        out[0, rows, 32:64] = (direction * (target / (0.125 * kmax))).bfloat16()
    return out


def mode_kernel_checks(args, dev, kernels: dict) -> dict:
    """Phase 27a: K4 and K5 in each mode (ATTN_MODES), K8 in the bf16
    epilogue and K7 in the forms the hybrid layout runs, at the main path's
    shapes, against their plain versions on the same inputs and timed by CUDA
    events; the bound's overshooting rows and its planted fault. Returns the
    kernel times by (kernel, mode)."""
    import torch

    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import int8_matmul as mm
    from chess_vision_tpu_torch.ops import rowquant as rq

    gen = torch.Generator(device=dev).manual_seed(args.seed + 27)
    N = SIZE // 16 * SIZE // 16 + 1
    NP = -(-N // 32) * 32
    H, D = 12, 768
    qkv = torch.randn((BATCH, N, 3 * D), device=dev, generator=gen).bfloat16()
    padded = torch.randn((BATCH, NP, 3 * D), device=dev,
                         generator=gen).bfloat16()
    padded[:, :N] = qkv
    flat = padded.reshape(BATCH * NP, 3 * D)
    real = lambda t: t.reshape(BATCH, NP, -1)[:, :N]  # noqa: E731
    times = {}
    for mode, kw in ATTN_MODES:
        for which in ("K4", "K5"):
            if which == "K4":
                run = lambda: attn_ops.fused_qkv_attention_quant(  # noqa: E731
                    qkv, H, **kw)
                plain = lambda: attn_ops.reference_attention_quant(  # noqa: E731
                    qkv, H, **kw)
                pick = lambda t: t  # noqa: E731
            else:
                run = lambda: attn_ops.fused_qkv_attention_quant_flat(  # noqa: E731
                    flat, BATCH, N, H, **kw)
                plain = lambda: attn_ops.reference_attention_quant_flat(  # noqa: E731
                    flat, BATCH, N, H, **kw)
                pick = real
            out, ref = run(), plain()
            torch.cuda.synchronize()
            w = attn_levels(*(pick(t) for t in (*out, *ref)))
            del out, ref
            ms = cuda_ms(run, 10)
            plain_ms = cuda_ms(plain, 2)
            times[(which, mode)] = ms
            print(f"[27a {which}] {mode} at {tuple((qkv if which == 'K4' else flat).shape)}"
                  f" H={H}: vs plain {w} (bound {ATTN_LEVELS} steps"
                  f"{f', rows beyond under {EXP_BF16_ROWS}, within {EXP_BF16_LEVELS}' if kw.get('exp_bf16') else ''}"
                  f"); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
            require(attn_ok(w, kw.get("exp_bf16", False)),
                    f"[27a {which}] {mode}: {w}")
            if which == "K4" and mode == "int8":
                kernels["fused_qkv_attention_quant_i8"] = kernel_entry(
                    "fused_qkv_attention_quant_i8", "attention_quant.cu",
                    "chess_vision_tpu/ops/attention.py:486", w["deq_levels"],
                    ms, plain_ms,
                    nbytes=2 * qkv.numel() + BATCH * N * D + 4 * BATCH * N,
                    ops={"int8": 2 * BATCH * H * N * N * 64,
                         "bf16": 2 * BATCH * H * N * N * 64})
    print(f"  [27a K4] ptxas: "
          f"{ptxas_counts('attention_quant_i8_kernel', 64)}", flush=True)

    # the bf16 exp's planted fault: the kernel's f32 exp against the plain
    # version's bf16 one must fail attn_ok
    planted = attn_levels(*attn_ops.fused_qkv_attention_quant(qkv, H),
                          *attn_ops.reference_attention_quant(qkv, H,
                                                              exp_bf16=True))
    caught = not attn_ok(planted, True)
    print(f"[27a K4] planted fault (the f32 exp against the plain bf16 exp): "
          f"{planted} ({'fails' if caught else 'PASSES'} the bf16 exp's "
          f"bounds)", flush=True)
    require(caught, "[27a K4] the planted fault (the f32 exp against the "
            "bf16 exp) passes")

    # the bound's overshooting rows, and its planted fault: the bound
    # without its -45 (the plain version with BOUND_OFFSET 0) must fail
    wild = overshoot_qkv(qkv, H)
    out = attn_ops.fused_qkv_attention_quant(wild, H)
    ref = attn_ops.reference_attention_quant(wild, H)
    with mock.patch.object(attn_ops, "BOUND_OFFSET", 0.0):
        bad = attn_ops.reference_attention_quant(wild, H)
    torch.cuda.synchronize()
    w, planted = attn_levels(*out, *ref), attn_levels(*out, *bad)
    zeros = bool((out[0][0, 4:8, :64] == 0).all() and (ref[0][0, 4:8, :64] == 0).all())
    kept = bool((out[0][0, 0:4, :64] != 0).any())
    print(f"[27a K4] overshooting bound (rows 0-3 by 70, 4-7 by 155): vs plain "
          f"{w}; rows 4-7 of head 0 zeros in both {zeros}, rows 0-3 not "
          f"{kept}; planted fault (the bound without its -45) vs the kernel "
          f"{planted['deq_levels']:.2f} steps (bound {ATTN_LEVELS}: "
          f"{'fails' if planted['deq_levels'] > ATTN_LEVELS else 'PASSES'})",
          flush=True)
    require(w["deq_levels"] <= ATTN_LEVELS and zeros and kept,
            f"[27a K4] overshooting bound: {w}, zeros {zeros}, kept {kept}")
    require(planted["deq_levels"] > ATTN_LEVELS,
            "[27a K4] the planted fault (the bound without its -45) passes")
    del qkv, padded, flat, wild, out, ref, bad

    # K8 in the bf16 epilogue, every GELU, beside the f32 epilogue in turns
    M = BATCH * N
    ops = operands_at(dev, gen, M, 768, 3072)
    for gelu in mm.GELUS:
        what = f"[27a K8] bf16 epilogue ({M}, 768) -> 3072 {gelu}"
        err = codes_check(what, *mm.int8_matmul_gelu_quant(
            *ops, gelu, bf16_epilogue=True),
            *mm.int8_matmul_gelu_quant_plain(*ops, gelu, bf16_epilogue=True))
        if gelu != "sigmoid":
            continue
        run = lambda: mm.int8_matmul_gelu_quant(  # noqa: E731
            *ops, gelu, bf16_epilogue=True)
        f32 = lambda: mm.int8_matmul_gelu_quant(*ops, gelu)  # noqa: E731
        turns = {"bf16": [], "f32": []}
        for which in ("bf16", "f32", "f32", "bf16"):
            turns[which].append(cuda_ms(run if which == "bf16" else f32, 20))
        plain_ms = cuda_ms(lambda: mm.int8_matmul_gelu_quant_plain(
            *ops, gelu, bf16_epilogue=True), 3)
        entry = kernel_entry(
            "int8_matmul_gelu_quant_bf16", "int8_matmul.cu",
            "chess_vision_tpu/ops/int8_matmul.py:219", err,
            min(turns["bf16"]), plain_ms,
            nbytes=M * 768 + 4 * M + 3072 * 768 + 8 * 3072 + M * 3072 + 4 * M,
            ops=2 * M * 768 * 3072, op_type="int8",
            library_ms=int_mm_ms(ops[0], ops[2], what))
        kernels[entry["name"]] = entry
        times[("K8", "bf16 epilogue")] = min(turns["bf16"])
        print(f"{what}: ms in turns (bf16, f32, f32, bf16) {turns}; plain "
              f"{plain_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms "
              f"({entry['bound_by']})", flush=True)
    del ops

    # K7 in the forms only the hybrid layout runs: none (768), GELU (3072)
    for width, mode in ((768, "none"), (3072, "gelu_sigmoid")):
        x = (torch.randn((M, width), device=dev, generator=gen) * 2).bfloat16()
        what = f"[27a K7] row quant ({M}, {width}) {mode}"
        q, s, rq_, rs = *rq.fused_rowquant(x, mode), *rq.rowquant_plain(x, mode)
        codes_check(what, q, s, rq_, rs)
        if mode == "none":  # no pre-op: the same quotient, the same bits
            require(torch.equal(q, rq_) and torch.equal(s, rs),
                    f"{what}: not bit-equal to its plain version")
        del q, s, rq_, rs
        ms = cuda_ms(lambda: rq.fused_rowquant(x, mode), 20)
        bound = (3 * M * width + 4 * M) / HBM_BYTES_PER_S * 1e3
        times[("K7", mode)] = ms
        print(f"{what}: kernel {ms:.4f} ms, bound {bound:.4f} ms (bytes): "
              f"{bound / ms:.3f} of it", flush=True)
        del x
    return times


def mode_want(layout: str, depth: int, batches: int) -> dict:
    """The launches of ``batches`` int8 forwards in the layouts phase 27 adds
    to ``int8_want``'s: hybrid, 4 row passes (K7) and 4 products a block and
    K2; xla, K2 alone (its products and quantizations are PyTorch's)."""
    hybrid = layout == "hybrid"
    return {"preprocess_u8": batches,
            "fused_qkv_attention": depth * batches,
            "fused_rowquant": 4 * depth * batches if hybrid else 0,
            "fused_qkv_attention_quant": 0,
            "fused_qkv_attention_quant_flat": 0,
            "fused_vit_block": 0,
            "int8_matmul_scale_bias": 4 * depth * batches if hybrid else 0,
            "int8_matmul_gelu_quant": 0,
            "int8_matmul_res_ln_quant": 0,
            "int8_matmul_res": 0}


def mode_path_check(tag: str, args, dev, cfg, params, boards, layout: str,
                    env: dict, kernels: dict, times: dict, check: int = BATCH,
                    long_entry: str | None = None) -> None:
    """Phase 27b: one Predictor(quant="int8") under ``env``, uncalibrated:
    two batches served with the counts set to 0 just before and read just
    after; ``check`` boards (a batch) with every int8 kernel call against
    its plain version (``path_op_checks``) and the logits against the plain
    path's (``INT8_SQUARES_ULPS``); the fused layout's first K14 on its
    path's block against its plain version and the split chain. The int8
    legs' launches count in the short route's kernels entry, or with
    ``long_entry`` (phase 28) every one on the long route, in that entry."""
    import torch

    from chess_vision_tpu_torch.experiments.plain import (forward_logits,
                                                          plain_int8_ops)
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import int8_matmul as mm
    from chess_vision_tpu_torch.ops import preprocess as pre_ops
    from chess_vision_tpu_torch.ops import quant
    from chess_vision_tpu_torch.serve import Predictor

    def build(batch: int):
        with mock.patch.dict(os.environ, {"CHESS_VISION_INT8_LAYOUT": layout,
                                          **env}):
            return Predictor((cfg, params), batch_size=batch, device=dev,
                             quant="int8")

    t0 = time.perf_counter()
    predictor = build(BATCH)
    want_modes = quant.Int8Modes(
        env.get("CHESS_VISION_ATTN_SOFTMAX", "bound"),
        env.get("CHESS_VISION_ATTN_QK", "bf16"),
        env.get("CHESS_VISION_ATTN_EXP", "f32"),
        env.get("CHESS_VISION_EPILOGUE", "f32"))
    require(predictor.layout == layout and predictor.attn_shifts is None
            and predictor.int8_modes == want_modes,
            f"{tag} layout {predictor.layout}, shifts {predictor.attn_shifts}, "
            f"modes {predictor.int8_modes}")
    predictor.predict_array(boards[:BATCH])  # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    depth = cfg["model"]["depth"]
    batches = math.ceil(len(boards) / BATCH)
    reset_counts()
    attn_ops.QUANT_I8_LAUNCHES = attn_ops.QUANT_I8_LONG_LAUNCHES = 0
    mm.BF16_EPILOGUE_LAUNCHES = 0
    t0 = time.perf_counter()
    fens = predictor.predict_array(boards)
    rate = len(boards) / (time.perf_counter() - t0)
    launches = int8_counts()
    legs, epilogue = attn_ops.QUANT_I8_LAUNCHES, mm.BF16_EPILOGUE_LAUNCHES
    long = attn_ops.QUANT_I8_LONG_LAUNCHES
    want = (mode_want(layout, depth, batches) if layout in ("hybrid", "xla")
            else int8_want(layout, depth, batches))
    want_legs = depth * batches if "CHESS_VISION_ATTN_QK" in env else 0
    want_long = want_legs if long_entry else 0
    want_epilogue = depth * batches if "CHESS_VISION_EPILOGUE" in env else 0
    print(f"{tag} {len(boards)} boards in {batches} batches of {BATCH}: "
          f"launches {launches}, int8 legs {legs} ({long} on the long route), "
          f"bf16 epilogue {epilogue}; {rate:.1f} boards/s (one run; set-up "
          f"{setup_s:.1f} s)", flush=True)
    require(launches == want and legs == want_legs and long == want_long
            and epilogue == want_epilogue,
            f"{tag} launch counts {launches}, legs {legs}, long {long}, "
            f"epilogue {epilogue}; want {want}, {want_legs}, {want_long}, "
            f"{want_epilogue}")
    if legs:
        kernels[long_entry or "fused_qkv_attention_quant_i8"]["launches"] += legs
    if epilogue:
        kernels["int8_matmul_gelu_quant_bf16"]["launches"] += epilogue

    worst = path_op_checks(predictor, boards[:check])
    print(f"{tag} each kernel call of {check} boards vs its plain version "
          f"(worst per op): {worst}", flush=True)
    require_path_ops(worst, tag, predictor.int8_modes.attn_exp == "bf16")
    logits_k = forward_logits(predictor, boards[:check])
    # the plain FENs from a Predictor of `check` boards a batch: served at
    # BATCH, the padded batch's plain scores would not fit the card at 640 px
    checker = predictor if check == BATCH else build(check)
    with plain_int8_ops(), plain_ops(attn_ops, pre_ops):
        logits_p = forward_logits(predictor, boards[:check])
        fens_plain = checker.predict_array(boards[:check])
    require_logits(tag, fens[:check], fens_plain, logits_k, logits_p,
                   INT8_SQUARES_ULPS)
    if layout == "fused":
        fused_bound_check(tag, args, predictor, kernels, times)


def fused_bound_check(tag: str, args, predictor, kernels: dict,
                      times: dict) -> None:
    """K14 with the bound (no calibrated shift) on the served model's block
    0 at the path's shape: against its plain version (``BLOCK_BOUNDS``) and
    bit for bit against the split chain, timed by CUDA events in turns with
    the calibrated-shift form."""
    import torch

    from chess_vision_tpu_torch.ops import fused_block as fb
    from chess_vision_tpu_torch.ops import quant
    from chess_vision_tpu_torch.ops import rowquant as rq

    dev = predictor.device
    gen = torch.Generator(device=dev).manual_seed(args.seed + 28)
    blocks = predictor.pack["blocks"]
    q, nxt = blocks[0], blocks[1]["norm1"]
    N = SIZE // 16 * SIZE // 16 + 1
    x = (torch.randn((BATCH, N, 768), device=dev, generator=gen) * 0.5).bfloat16()
    xq, xs = rq.fused_rowquant(x, "ln", q["norm1"]["scale"], q["norm1"]["bias"])
    run = lambda shift=None: fb.fused_vit_block(  # noqa: E731
        xq, xs, x, q, nxt, 12, shift)
    out, chain = run(), quant.block_int8(x, xq, xs, q, nxt, 12)
    ref = fb.fused_vit_block_plain(xq, xs, x, q, nxt, 12)
    torch.cuda.synchronize()
    as_chain = all(bool((a == b).all()) for a, b in zip(out, chain))
    diff = block_diff(out, ref)
    del out, chain, ref
    turns = {"bound": [], "fixed": []}
    for which in ("bound", "fixed", "fixed", "bound"):
        turns[which].append(cuda_ms(
            lambda: run(None if which == "bound" else 0.0), 5))
    times[("K14", "bound")] = min(turns["bound"])
    print(f"{tag} K14 with the bound, block 0 at ({BATCH}, {N}, 768): vs plain "
          f"{diff}; bit-identical to the split chain {as_chain}; ms in turns "
          f"(bound, fixed, fixed, bound) {turns}", flush=True)
    require(block_ok(diff), f"{tag} K14 with the bound vs plain: {diff}")
    require(as_chain, f"{tag} K14 with the bound differs from the split chain")


def int8_modes_phase(args, cfg, params, kernels: dict, kind: str,
                     smi: str) -> None:
    """Phase 27: the int8 path's serving modes and the hybrid and xla
    layouts (MODE_PATHS), uncalibrated, at full width."""
    import torch

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    times = mode_kernel_checks(args, dev, kernels)
    boards = path_boards(args, np.random.default_rng(args.seed + 27), 2 * BATCH)
    for tag, layout, env in MODE_PATHS:
        mode_path_check(f"[27b {tag}]", args, dev, cfg, params, boards, layout,
                        env, kernels, times)
        torch.cuda.empty_cache()
    print(f"[27 modes] kernel ms by (kernel, mode): "
          f"{ {f'{k} {m}': round(v, 4) for (k, m), v in times.items()} }; "
          f"{kind}, {smi}", flush=True)
    print(f"[27 modes] phase {time.perf_counter() - t_phase:.1f} s", flush=True)


# Phase 28 (a): K4 and K5 on the int8 legs at head dim 64, (keys, heads) of 2
# images: just past each form's short-route limit (960, 1,056 and 1,504 keys)
# and ViT-B/16 at 640 and 768 px (1,601 and 2,305 tokens); and just past
# qk_int8's limit at head dims 16 and 32, (head dim, keys) on 3 heads
LONG_CASES = ((961, 2), (1057, 3), (1505, 4), (1601, 12), (2305, 2))
LONG_DIMS = ((16, 2721), (32, 1729))
LEG_FORMS = ATTN_MODES[4:]  # int8, pv only, int8pv
# (b) and (c): ViT-B/16 served at 640 px, 1,601 tokens; the plain versions
# on this many images or boards (the plain scores of 16 images are 2 GB in
# f32, 4 GB for the f64 products)
LONG_SIZE = 640
LONG_CHECK = 16
# (c)'s Predictors, uncalibrated: (tag, layout, variables, the kernels entry
# of their int8 legs' launches)
LONG_PATHS = (
    ("block bound", "block", {}, None),
    ("block int8", "block", {"CHESS_VISION_ATTN_QK": "int8"},
     "fused_qkv_attention_quant_i8_long"),
    ("block int8pv", "block", {"CHESS_VISION_ATTN_QK": "int8pv"},
     "fused_qkv_attention_quant_i8_long"),
    ("flat int8", "flat", {"CHESS_VISION_ATTN_QK": "int8"},
     "fused_qkv_attention_quant_flat_i8_long"),
    ("flat int8pv", "flat", {"CHESS_VISION_ATTN_QK": "int8pv"},
     "fused_qkv_attention_quant_flat_i8_long"),
)


def leg_bits(kw: dict) -> int:
    """The int8 legs of the quantizing attention's keywords, as the C entry
    numbers them: 1 qk_int8, 2 pv_int8, 3 both."""
    return int(kw.get("qk_int8", False)) | 2 * int(kw.get("pv_int8", False))


def forced_route(qkv, images: int, n_real: int, heads: int, kw: dict,
                 route: str) -> tuple:
    """K4 (qkv 3-D) or K5 (2-D, ``images`` of equally many rows) on the
    int8 legs' ``route``: (codes, scales) with a row of each per row of
    qkv."""
    import torch

    from chess_vision_tpu_torch.ops import attention as attn_ops

    rows = qkv.shape[0] * qkv.shape[1] if qkv.dim() == 3 else qkv.shape[0]
    D = qkv.shape[-1] // 3
    oq = torch.empty((rows, D), dtype=torch.int8, device=qkv.device)
    os_ = torch.empty((rows, 1), dtype=torch.float32, device=qkv.device)
    attn_ops._launch_quant(qkv, oq, os_, images, rows // images, n_real, heads,
                           D // heads, None, "max", kw.get("qk_int8", False),
                           kw.get("pv_int8", False), False,
                           "phase 28's int8 legs", route)
    return oq, os_


def legs_case(dev, gen, n: int, H: int, dh: int, kw: dict,
              pad_gain: float = 1.0) -> dict:
    """K4 on 2 images of n tokens of H heads of dh and K5 on them padded
    past n (``pad_gain`` times the padded V rows, which V's column scales
    see) against their plain versions (``attn_levels``), on ``i8_plan``'s
    route: one launch a call, counted on it."""
    import torch

    from chess_vision_tpu_torch.ops import attention as attn_ops

    B, C3 = 2, 3 * H * dh
    route = attn_ops.i8_plan(n, dh, leg_bits(kw))[0]
    np_ = -(-n // 32) * 32 + 32
    padded = torch.randn((B, np_, C3), device=dev, generator=gen)
    padded[..., :H * dh] *= 3
    padded[:, n:, 2 * H * dh:] *= pad_gain
    padded = padded.bfloat16()
    qkv = padded[:, :n].contiguous()
    flat = padded.reshape(B * np_, C3)
    before = attn_ops.QUANT_I8_LAUNCHES, attn_ops.QUANT_I8_LONG_LAUNCHES
    out = attn_ops.fused_qkv_attention_quant(qkv, H, **kw)
    fout = attn_ops.fused_qkv_attention_quant_flat(flat, B, n, H, **kw)
    torch.cuda.synchronize()
    moved = (attn_ops.QUANT_I8_LAUNCHES - before[0],
             attn_ops.QUANT_I8_LONG_LAUNCHES - before[1])
    real = lambda t: t.reshape(B, np_, -1)[:, :n]  # noqa: E731
    ref = attn_ops.reference_attention_quant_flat(flat, B, n, H, **kw)
    return {"route": route,
            "launches": moved == (2, 2 if route == "long" else 0),
            "K4": attn_levels(*out, *attn_ops.reference_attention_quant(
                qkv, H, **kw)),
            "K5": attn_levels(*(real(t) for t in (*fout, *ref)))}


def long_leg_checks(args, dev) -> None:
    """Phase 28 (a): the long route's lengths and head dims against the
    plain versions (``LONG_CASES``, ``LONG_DIMS``; K5 with padded V rows
    nine times larger than the real ones past the limit), and the two routes
    bit for bit where both take a head (257 keys, every form; 1,504, both
    legs), in K4 and K5."""
    import torch

    from chess_vision_tpu_torch.ops import attention as attn_ops

    gen = torch.Generator(device=dev).manual_seed(args.seed + 281)
    cases = [(n, H, 64) for n, H in LONG_CASES] + [(n, 3, dh) for dh, n in LONG_DIMS]
    for n, H, dh in cases:
        for mode, kw in LEG_FORMS:
            pad = 9.0 if n == 1601 else 1.0
            w = legs_case(dev, gen, n, H, dh, kw, pad)
            ok = w["launches"] and attn_ok(w["K4"], False) and attn_ok(w["K5"], False)
            print(f"[28a long legs] {mode} (2, {n}, {3 * H * dh}) H={H} on the "
                  f"{w['route']} route{' (K5 padded V x9)' if pad > 1 else ''}: "
                  f"K4 {w['K4']['deq_levels']:.3f}, K5 {w['K5']['deq_levels']:.3f} "
                  f"steps of plain (bound {ATTN_LEVELS}); one launch a call "
                  f"on its route {w['launches']}", flush=True)
            require(ok, f"[28a long legs] {mode} at {n} keys, head dim {dh}: {w}")
    for n in (257, 1504):
        qkv = torch.randn((2, n + 32, 3 * 768), device=dev, generator=gen).bfloat16()
        for mode, kw in LEG_FORMS:
            if not attn_ops.i8_short_fits(n, 64, leg_bits(kw)):
                continue
            same = []
            for x, images in ((qkv[:, :n].contiguous(), 2),
                              (qkv.reshape(-1, 3 * 768), 2)):
                short = forced_route(x, images, n, 12, kw, "short")
                long = forced_route(x, images, n, 12, kw, "long")
                torch.cuda.synchronize()
                same.append(all(torch.equal(a, b) for a, b in zip(short, long)))
            print(f"[28a long legs] {mode} at {n} keys, 12 heads: long route "
                  f"bit-equal to the short one in K4 and K5 {same}", flush=True)
            require(all(same), f"[28a long legs] {mode} at {n} keys: the routes differ")


def long_leg_times(args, dev, kernels: dict) -> None:
    """Phase 28 (b): K4 at (256, 1601, 2304) and K5 at (256 * 1632, 2304),
    each form on the long route, timed by CUDA events beside the bound and
    the plain version's time on LONG_CHECK images; the first LONG_CHECK
    images against it; the kernels line's two long entries (K4 int8, K5
    int8pv: the plain version timed over the whole batch, LONG_CHECK images
    at a time); the two routes in turns at (256, N, 2304) for N of 257, 960
    and 1,504 keys, each form the short route takes there; ptxas's registers
    and spills of every long instantiation."""
    import torch

    from chess_vision_tpu_torch.ops import attention as attn_ops

    gen = torch.Generator(device=dev).manual_seed(args.seed + 282)
    N = (LONG_SIZE // 16) ** 2 + 1
    NP = -(-N // 32) * 32
    H, D, sub = 12, 768, LONG_CHECK
    padded = torch.randn((BATCH, NP, 3 * D), device=dev, generator=gen).bfloat16()
    qkv = padded[:, :N].contiguous()
    flat = padded.reshape(BATCH * NP, 3 * D)
    for mode, kw in LEG_FORMS:
        legs = leg_bits(kw)
        for which in ("K4", "K5"):
            if which == "K4":
                run = lambda: attn_ops.fused_qkv_attention_quant(qkv, H, **kw)  # noqa: E731
                plain = lambda x: attn_ops.reference_attention_quant(x, H, **kw)  # noqa: E731
                parts = [qkv[i:i + sub] for i in range(0, BATCH, sub)]
                pick = lambda t: t[:sub]  # noqa: E731
                rows, shape = N, tuple(qkv.shape)
            else:
                run = lambda: attn_ops.fused_qkv_attention_quant_flat(  # noqa: E731
                    flat, BATCH, N, H, **kw)
                plain = lambda x: attn_ops.reference_attention_quant_flat(  # noqa: E731
                    x, sub, N, H, **kw)
                parts = [flat[i * NP:(i + sub) * NP] for i in range(0, BATCH, sub)]
                pick = lambda t: t[:sub * NP].reshape(sub, NP, -1)[:, :N]  # noqa: E731
                rows, shape = NP, tuple(flat.shape)
            out = run()
            ref = plain(parts[0])
            torch.cuda.synchronize()
            w = attn_levels(*(pick(t) for t in (*out, *ref)))
            del out, ref
            ms = cuda_ms(run, 3)
            plain_sub = cuda_ms(lambda: plain(parts[0]), 1)
            products = 2 * BATCH * H * rows * N * 64  # each of QK^T and P V
            ops = {"int8": 2 * products} if legs == 3 else {"int8": products,
                                                            "bf16": products}
            nbytes = 2 * BATCH * rows * 3 * D + BATCH * rows * (D + 4)
            entry = {("K4", "int8"): "fused_qkv_attention_quant_i8_long",
                     ("K5", "int8pv"): "fused_qkv_attention_quant_flat_i8_long"
                     }.get((which, mode))
            plain_ms = None
            if entry:  # the kernels line's: the plain version over the batch
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for part in parts:
                    plain(part)
                end.record()
                torch.cuda.synchronize()
                plain_ms = start.elapsed_time(end)
            bound = kernel_entry(
                entry or f"{which} {mode}", "attention_quant_long.cu",
                "chess_vision_tpu/ops/attention.py:"
                + ("486" if which == "K4" else "772"), w["deq_levels"], ms,
                plain_ms, nbytes=nbytes, ops=ops)
            if entry:
                kernels[entry] = bound
            print(f"[28b long legs] {which} {mode} at {shape} H={H} on the "
                  f"{attn_ops.i8_plan(N, 64, legs)[0]} route: kernel {ms:.4f} ms, "
                  f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
                  f"{nbytes / 1e9:.3f} GB, {ops}); plain {plain_sub:.4f} ms on "
                  f"{sub} images{f', {plain_ms:.4f} ms over all {BATCH}' if plain_ms else ''}; "
                  f"first {sub} images vs plain {w}", flush=True)
            require(attn_ok(w, False), f"[28b long legs] {which} {mode}: {w}")
    del padded, qkv, flat
    # the two routes in turns where both take a head: ViT-B/16 at 256 px,
    # and each form's last lengths on the short route
    for n in (SIZE // 16 * SIZE // 16 + 1, 960, 1504):
        x = torch.randn((BATCH, n, 3 * D), device=dev, generator=gen).bfloat16()
        for mode, kw in LEG_FORMS:
            if not attn_ops.i8_short_fits(n, 64, leg_bits(kw)):
                continue
            turns = {"short": [], "long": []}
            for route in ("short", "long", "long", "short"):
                turns[route].append(cuda_ms(
                    lambda: forced_route(x, BATCH, n, H, kw, route), 5))
            print(f"[28b long legs] {mode} at {tuple(x.shape)} H={H}, ms in turns "
                  f"(short, long, long, short): {turns}", flush=True)
        del x
    warps = attn_ops._I8_LONG_WARPS
    for dh in (16, 32, 64):
        counts = {mode: ptxas_counts("attention_quant_i8_long_kernel", dh,
                                     flags=(kw.get("qk_int8", False),
                                            kw.get("pv_int8", False)))
                  for mode, kw in LEG_FORMS}
        print(f"  [28b long legs] ptxas at head dim {dh} (launch bounds "
              f"{32 * warps} threads, {12 // warps} blocks and 12 warps an SM): "
              f"{counts}", flush=True)


def long_path_phase(args, dev, kernels: dict) -> None:
    """Phase 28 (c): ViT-B/16 served in int8 at 640 px (1,601 tokens), random
    weights from --seed, 2 batches of 256 boards resized from 256 px as the
    loader resizes them: the bound (no legs, K4's own kernel) in the block
    layout, then the int8 legs (``CHESS_VISION_ATTN_QK`` int8 and int8pv) in
    the block (K4) and flat (K5) layouts, each as phase 27b checks a mode
    with LONG_CHECK boards against the plain path, every legs launch on the
    long route; the fused layout under int8pv serves one batch as the block
    layout (the JAX rule)."""
    import torch

    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.serve import Predictor

    cfg = {"model": dict(FULL_WIDTH, input_size=LONG_SIZE),
           "training": {"mixed_precision": True}}
    params = random_jax_params(cfg, args.seed)
    boards = MemoryCorpus(2 * BATCH, args.seed + 28, LONG_SIZE).boards
    times = {}
    for tag, layout, env, entry in LONG_PATHS:
        mode_path_check(f"[28c {tag} {LONG_SIZE}px]", args, dev, cfg, params,
                        boards, layout, env, kernels, times, check=LONG_CHECK,
                        long_entry=entry)
        torch.cuda.empty_cache()
    with mock.patch.dict(os.environ, {"CHESS_VISION_INT8_LAYOUT": "fused",
                                      "CHESS_VISION_ATTN_QK": "int8pv"}):
        predictor = Predictor((cfg, params), batch_size=BATCH, device=dev,
                              quant="int8")
    reset_counts()
    attn_ops.QUANT_I8_LAUNCHES = attn_ops.QUANT_I8_LONG_LAUNCHES = 0
    fens = predictor.predict_array(boards[:BATCH])
    launches = int8_counts()
    legs, long = attn_ops.QUANT_I8_LAUNCHES, attn_ops.QUANT_I8_LONG_LAUNCHES
    depth = cfg["model"]["depth"]
    print(f"[28c fused int8pv {LONG_SIZE}px] {len(fens)} boards in one batch: "
          f"launches {launches}, int8 legs {legs} ({long} on the long route): "
          f"the block layout's", flush=True)
    require(launches == int8_want("block", depth, 1) and legs == long == depth,
            f"[28c fused int8pv] launches {launches}, legs {legs}, long {long}")
    kernels["fused_qkv_attention_quant_i8_long"]["launches"] += long


def long_legs_phase(args, kernels: dict, kind: str, smi: str) -> None:
    """Phase 28: the int8 legs' long route, at every length and on ViT-B/16
    at 640 px."""
    import torch

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    long_leg_checks(args, dev)
    long_leg_times(args, dev, kernels)
    torch.cuda.empty_cache()
    long_path_phase(args, dev, kernels)
    print(f"[28 long legs] phase {time.perf_counter() - t_phase:.1f} s; {kind}, "
          f"{smi}", flush=True)

if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # any phase's failure: report it, exit non-zero
        traceback.print_exc()
        print("FAIL", file=sys.stderr)
        sys.exit(1)
