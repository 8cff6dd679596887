#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (edm_tts_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR] [--parent-f32 DIR]

Phases, each reported on its own line:
  1. environment: torch / CUDA versions and the card's name and power limit;
  2. build: nvcc builds the kernels from edm_tts_tpu_torch/csrc;
  3. kernels: each hand-written kernel (K1 residual unit, K2 decoder block,
     K3 attention, K3 with its LSE output and K4 attention backward, K5 int8
     dense, K6 the attention-variant ablation) against its plain PyTorch
     version at the shapes of the synthesis, serving, training and ablation
     paths in bf16 (K5 at one request's linears and at those of a served
     engine call in bucket 4, each at the tile its wrapper picks, beside
     the bf16 matmul on the dequantized weight; K1 at one request's 12
     units, those of a served call in bucket 4 and of a one-row call, and
     the codec encoder's 12 on path (g)'s 10 s and 3 s prompts (C 64-512,
     up to 160160 rows) and on its batch of 4 (B4, up to 160160 rows),
     each at the N tile its wrapper picks, beside cuDNN's conv1d and a
     matmul of its two convolutions, as information; K3 also at
     HuBERT-large's shapes (B1 T500 H16 D64, and B4 with a key mask); K2 at one request's
     two blocks, its front alone at the column tile its wrapper picks
     beside its bound, cuDNN's conv_transpose1d and, with ``--parent
     DIR``, another checkout's front): relative l2 and max
     abs error within their limits (K3's LSE also within an absolute
     limit), planted faults of the plain version outside them, median times of the kernel, the plain version and, where
     one PyTorch call computes the same function, that call (for K4 the
     backward of scaled_dot_product_attention: forward and backward timed,
     the forward subtracted; for K6 SDPA's forward); the least time the card
     could take (utils/devtime.py: bytes over 3.35 TB/s, products over 989
     TFLOP/s, exponentials over 3.9e12/s, the H100 SXM's peaks); and K3's
     and K5's f32 kernels against their plain f32 versions (TF32 off) at
     the f32 path's shapes (ATTENTION_F32_CASES, an edge case
     ATTENTION_F32_EDGE_CASE, and for K3 also the training shapes
     ATTENTION_TRAIN_CASES and GPipe's PIPE_ATTENTION_CASES; K5 at the 31
     int8 cases with f32 activations),
     and K4's f32 kernel at the bf16 K4's cases, beside SDPA f32 (for K4
     its f32 backward) and the f32 matmul on the dequantized weight, bound
     at the split-TF32 rates (495/3 TFLOP/s for K3 and K4, 495/2 for K5,
     whose int8 weight is exact in TF32), within 2^-16 relative l2 and
     2^-14 of the largest output (K3-f32's LSE also within F32_LSE_ABS_TOL,
     and a second call equal to the bit); with ``--parent-f32 DIR``,
     another checkout's K3-f32 and K4-f32 timed beside; K1 and K3 also at
     path (j)'s dump shapes (the encoder's 12 units at B8 x 960160 samples,
     HuBERT at B8 T3000 with a ragged key mask); the ring attention's steps
     on one card (RING_SHAPES x RING_SIZES, a row without valid keys: K3
     with its LSE per key chunk merged in f32, K4 per chunk with the merged
     output and LSE) against the same steps through the plain versions and
     against one whole-sequence K3 / K4 call;
  4. end to end: full-width models (the default codec and s2a, the t2s of
     bench.py; edm_tts_tpu_torch/profile_synthesis.py builds them) from a
     seeded random init in bf16 answer (a) a 10 s request with a given
     length on a full canvas, as bench.py runs it, and (b) a request that
     uses the length predictor and the masked canvas; checks shapes, finite
     non-silent audio, codes in range, the kernels' launch counts, and the
     decode against the plain versions; prints the wall seconds per second
     of audio of (a); then the Conformer API on the bf16 t2s
     (``extract_features``, conformer_api_check): ``output_layer_idx`` runs
     exactly its blocks' K3 launches and gives their output of a full
     forward, ``return_attn`` launches no kernel and gives row-stochastic
     f32 maps and a final state within REL_L2_TOL of the kernels';
  5. served path (c): the same models with int8 weights behind TTSEngine,
     DynamicBatcher and TTSServer over HTTP on 127.0.0.1: four concurrent
     requests (one with a given length) and one long request of three
     chunks; checks the WAVs, that the batcher coalesced requests, the
     kernels' launch counts (K5 on every quantized linear, K3, K1, and no
     K2 on the masked decode), that K5 and K1 ran only at shapes phase 3
     held against their plain versions (each printed with its launches),
     the int8 s2a's logits against the bf16 ones and the masked decode
     against exact-size decodes; prints each request's latency and the engine's
     wall per second of audio;
  6. prompt tokenization (g): HuBERT-large to layer 18 with 1024 centroids
     (profile_tokenization.full_width_semantic) and the s2a's default codec,
     bf16, seeded, in the engine of (c) behind a TTSServer: a 3 s and a 10 s
     seeded prompt at 24 kHz registered with POST /speakers (200 each; the
     resampler runs), then one /synthesize with the 10 s speaker, checked
     as (c) checks its WAVs; per prompt: codec frames = HuBERT frames =
     get_code_lengths, codes in range, 12 K1 and 18 K3 launches and no
     other kernel, every K1 shape among phase 3's cases; the served codes
     equal to AudioTokenizer.run_steps' on the request's own resampled,
     padded and normalized audio, and that run's encoder latents and
     HuBERT's layer-18 states against the same models through the plain
     versions (bf16, relative l2 and the shares of identical semantic ids
     and level-0 codes within their limits) and the ids' flip shares
     against the plain f32 models; the batched path (compute_codes_batch
     on 4 prompts of 3-10 s with the attention mask) with the same launch,
     shape and plain-version checks over each row's frames (the level-0
     codes' share printed, not held), and each row's semantic ids and codes
     of all levels against its exact-size call; prints the wall and device
     time per second of prompt audio, the busy share and each part's time
     (profile_tokenization);
  7. model directories and the CLIs (h): the default codec and s2a,
     bench.py's t2s and HuBERT-large with 1024 centroids, f32, seeded,
     written as directories (reference model.safetensors, the t2s also as
     pytorch_model.bin, HuBERT as an HF directory with centroids.npy) with
     a 3 s 24 kHz prompt as WAV and FLAC; four ``python -m
     edm_tts_tpu_torch.inference`` runs (bf16 and f32, --quantize int8,
     --text_file of 3 lines, --long, --one_shot) and two ``python -m
     edm_tts_tpu_torch.serve`` (bf16 and f32: --speaker, /synthesize,
     /speakers, /healthz, /stats, SIGTERM -> exit 0) at once, each
     process's kernel launches and WAV lengths checked; in this process an
     f32 int8 TTSEngine.from_dirs whose registration and request are the
     f32 kernels' counted launches (no K1, K2 or bf16 kernel), its
     tokenization held against the plain versions (cli_path);
  8. training (d): the s2a recipe of configs/injection_conformer/
     train_config.yaml (d1024, 16 layers, B32 x 768 frames in 4
     micro-batches, bf16 autocast, f32 weights and AdamW state) through
     train.run_s2a.main_from_dict on seeded token shards and a seeded random
     init, 6 optimizer steps with a 2-step warmup; first one micro-batch's
     loss and gradient through K3+K4 against the same step on the same
     model with the Conformer's attention replaced by the plain version for
     that one call (and a planted K4 fault outside the limit); checks
     finite losses and gradient norms, the frozen codec unchanged, every
     trainable tensor moved and 16 K3 and 16 K4 launches per micro-batch;
     prints seconds per step, frames per second, peak device memory and
     the final checkpoint's size and save time;
  9. training (e): the t2s recipe of configs/text_to_semantic_w_length/
     train_config.yaml (hidden 384, 12 + 4 layers, heads 8 x 24, B32, lr
     2.5e-4, bf16 autocast) through train.run_t2s.main_from_dict on 2100
     seeded items (length-bucketed batches), 6 steps with a 2-step warmup;
     first one batch of 8 through K3+K4 against the plain attention as in
     (d); checks finite losses and gradient norms, every trainable tensor
     moved, 16 K3 and 16 K4 launches per step and at least two canvas
     lengths; prints seconds per step, canvas tokens per second and peak
     device memory;
 10. gradient checkpointing: one full-width s2a micro-batch (B8 x 768,
     dropout 0.1, a fixed generator) under the remat policies "full",
     "mha" and "dots" against none: gradients within REMAT_GRAD_REL_L2_TOL,
     32 K3 launches under "full" and 16 under the others, peak memory of
     each; then 2 steps of the s2a recipe as B32 in one micro-batch under
     "mha" (step time, peak memory);
 11. ablation (f): K6's variants and query tiles at B32 T1408 H16 D24
     through profile_attn_variants.sweep, with its launches counted;
 12. f32 training (i): the s2a recipe with bf16: false (B32 x 768 in 4
     micro-batches, TF32 off): first one micro-batch's loss and gradient
     through K3-f32 + K4-f32 against the plain f32 attention (limits
     TRAIN_F32_*) and under the remat policies "mha" (no extra K3-f32) and
     "full"; then 3 steps with watch: all and a tracker (TRACKER_SPEC), the
     watch norms of every trainable tensor finite and at the tracker; then
     3 steps of the t2s recipe at f32; launches exactly depth x
     micro-batches x steps of K3-f32 and of K4-f32 and nothing else;
     prints step seconds, frames per second and peak memory;
 13. offline preprocessing (j): seeded FLACs (40 LibriSpeech-layout
     utterances of 3-15 s, two 4-minute LibriLight books), a full-width f32
     HuBERT-large HF directory and the default codec; ``python -m
     edm_tts_tpu_torch.hubert_kmeans`` (layer 18, K 1024) writes centroids
     into a new HuBERT directory, ``python -m edm_tts_tpu_torch.dump_tokens``
     tokenizes the 8 windows of 60 s in one bf16 batch of 8 with them (each
     CLI's launches checked, the shards' shapes and ranges), then one step
     of the s2a recipe on the shards read by run_s2a.code_batch_iterator;
     and the k-means fit at the CLI's default size (1,024,000 x 1024 f32
     seeded frames), its inertia never rising (KMEANS_INERTIA_RISE_TOL);
 14. codec GAN training (k): ``python -m edm_tts_tpu_torch.train.run_codec``
     on configs/dac/train_config.yaml (CODEC_RECIPE: the full generator and
     discriminators, B32 x 0.38 s, f32 with TF32 off) over seeded
     LibriLight-layout books, CODEC_TRAIN_STEPS steps with one eval, one
     save and the best generator exported, the trainer's restore of that
     checkpoint checked in this process (G, D and both optimizers as saved),
     then resumed to CODEC_RESUME_STEPS; prints each step's losses and the
     device time of each phase (the generator's forward, the D step, the G
     step, the optimizers), the median step, segments per second and peak
     memory; fails on a non-finite loss or any kernel launch in the f32
     runs. Then the export loaded in bf16 (``load_codec``) round-trips a
     seeded 2 s clip through K1 and K2 (24 and 2 launches), held against
     the plain versions, and the gradient of a loss on its encoder latents
     and decoded audio through K1 and K2 under autograd (backward: the plain
     composition's VJP) is held against the same model through the plain
     versions (the flattened gradient, CODEC_GRAD_REL_L2_TOL) and, tensor by
     tensor, against the same model's f32 gradient (no farther than the
     plain bf16 composition, CODEC_GRAD_NOISE_FACTOR), a planted fault of
     K1's backward outside; K1 also at the clip's 24 unit shapes and K2 at
     its two blocks in phase 3.
 15. the closed-loop rehearsal (l): ``edm_tts_tpu_torch.closed_loop.run`` at
     full width in a fresh temporary root (LOOP_*): a seeded LibriSpeech-
     layout set of 4 x 30 utterances, a seeded f32 HuBERT-large, then
     through the port's CLIs on the card the codec of CODEC_RECIPE trained
     to its best_model export, ``hubert_kmeans`` (K 1024), ``dump_tokens``
     (f32), the t2s and s2a recipes at f32 (6 steps each, the s2a on that
     codec) and the JAX script's f32 inference with its final wav check;
     then a bf16 ``--quantize int8 --one_shot`` inference on the same
     directories; each stage's kernel launches checked exactly, the
     artifacts (12 codebooks, (1024, 1024) finite centroids, the shards'
     ranges, both exports, every logged loss finite) and both wavs; prints
     each stage's wall seconds and the loop's.
 16. the multi-device layer (m): ``python -m torch.distributed.run
     --nproc_per_node 1 chip_smoke.py --dp-step DIR`` (one NCCL rank,
     dp_step_worker): (d)'s s2a recipe at full width through the
     data-parallel ``Trainer`` (ZeRO-2 ``AdamW``: NCCL's reduce-scatter and
     all-gather on the card) for DP_STEPS steps, the first against the
     one-process ``Trainer`` on the same batch and init (loss and
     parameters), 64 K3 and 64 K4 launches a step; prints step seconds and
     peak memory; then two engine replicas on this card (``mesh=[dev,
     dev]``, bucket 2) in bf16 and f32, float and int8 weights: twice one
     engine's launches; the audio equal to the bit to a witness
     (``replica_witness``: the replicas' parts run one after another on
     one engine's models through ``t2s_sample``/``s2a_sample`` with each
     part's ``row_offset``) and, but for bf16 with float weights, to one
     engine's; bf16 with float weights prints its gap to one engine.
 17. GPipe (n) (``pipeline_path``): the full-width s2a of (d) (seeded init,
     bf16 autocast) on B8 x 768 seeded tokens in PIPE_MICRO microbatches
     through ``models.s2a.pipeline.pipelined_train_loss`` on local pipe
     meshes of 4 stages and of 1 (all stages in this process), in turns
     PIPE_REPEATS times: the loss and every gradient equal to the bit
     between the two and across repeats, each within TRAIN_LOSS_REL_TOL /
     TRAIN_GRAD_REL_L2_TOL of ``forward_train(..., mask_override=mask,
     train=False)`` on the whole batch (the gradients' relative l2 over
     all of them and for each leaf the pipe writes itself: the injection
     projections, the embeddings and the mask token), 64 K3 and 64 K4
     launches a step; K3 with its LSE and K4 on the q, k, v of the first
     and the last attention of the step (B2 x 768 x 16 x 64 bf16) against
     the plain versions at phase 3's limits;
     prints the median step wall, peak memory and one profiled step's
     device time of each; then ``python -m torch.distributed.run
     --nproc_per_node 1 -m edm_tts_tpu_torch.dryrun_multichip`` (one NCCL
     rank: leg 1, the tiny s2a's ZeRO-2 step) must exit 0.
The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before it.
There is no CPU fallback: without a CUDA device the script fails.

    python3 chip_smoke.py --source-faults

plants each of SOURCE_FAULTS in a copy of K1's and K2's (the GEMM they
share), K3's, K4's, K5's, K6's or the f32 K3's, K4's (or the split-TF32
parts the two share) and K5's CUDA source (the
package and this script copied into a temporary directory, built there)
and runs the cases of phase 3 that hold that kernel on it: K1's
one-request and encoder cases and K2's (``--codec-kernels``), K5's
(``--int8-kernels``), the f32 kernels' (``--f32-kernels``), or the
K3-with-LSE/K4 and ragged K6 ones (``--attention-kernels``); each
exits 3 when a case is outside its limits.
The sources as they are must pass first, and it exits 1 if any fault
passes.

    python3 chip_smoke.py --closed-loop

builds the kernels and runs only the Conformer API check and path (l);
it exits 3 when a check fails.

    python3 chip_smoke.py --pipeline

builds the kernels and runs only path (n); it exits 3 when a check fails.
"""

from __future__ import annotations

import contextlib
import gc
import io
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
# the ring attention's cases of phase 3: the s2a training micro-batch and a
# ragged length padded to the ring, over rings of RING_SIZES
RING_SHAPES = ((8, 768, 16, 64), (4, 701, 16, 64))
RING_SIZES = (2, 4)
# Kernel against plain version: the relative l2 error ||out - ref|| / ||ref||
# must stay under REL_L2_TOL. Kernel and plain version round intermediates
# to bf16 at different points, which leaves ~0.3 % (K1, K2) to ~0.6 % (K3)
# and ~0.003 % (K5, which rounds only its output); leaving out a bias, a
# snake alpha or a scale, dropping the keys of a tail tile or the last K
# step, ignoring the mask or scaling by the padded head depth moves it by
# 8 % or more. Each case also shows, on the plain version, that the limit
# rejects such planted faults.
REL_L2_TOL = 2.0 ** -6
# and no element may be off by more than 2^-5 of the output's largest
# magnitude (4-8 bf16 ulps there): catches a few rows gone wrong, which
# barely move a relative l2 error over millions of elements
MAX_ABS_TOL = 2.0 ** -5
# K3's LSE against its plain version, absolute (measured 9.5e-7 on an
# H100): an LSE off by e scales every probability K4 rebuilds by exp(-e),
# so the relative limits above, at LSE values ~7, would pass a 10 % error
# in every gradient
LSE_ABS_TOL = 1e-4
# K3-f32's LSE, absolute: the limit tests/test_torch_kernels_f32_gpu.py
# holds it to (an f32 LSE in another summation order is off by ~1e-6)
F32_LSE_ABS_TOL = 1e-5
# K3's and K5's f32 kernels against their plain f32 versions (TF32 off): f32
# products in another summation order leave ~1e-7 to 1e-6; an operand
# rounded to bf16 or to TF32 (10 mantissa bits), a dropped tail tile, mask or
# scale moves the output by 2^-11 or more. Set before the kernels' first run.
F32_REL_L2_TOL = 2.0 ** -16
F32_MAX_ABS_TOL = 2.0 ** -14
# (h): the f32 engine's prompt tokenization against the same f32 models with
# every plain version swapped in: the share of frames whose semantic id and
# level-0 code agree (only K3's f32 kernel differs from its plain version,
# ~1e-6), and HuBERT's layer-18 states' relative l2
F32_TOKENIZE_SAME = 0.99
F32_TOKENIZE_REL_L2_TOL = 1e-4
# (h): the CLIs' runs (seconds each may take; the models load from disk)
CLI_TIMEOUT_S = 600
# the int8 s2a's level-0 logits against the bf16 s2a's on one seeded canvas:
# measured 0.022 on an H100; the limit is about twice that, and a third of
# the 15 % loss rule the JAX package's own test holds int8 weights to
INT8_LOGITS_REL_L2_TOL = 0.05
# a decode against another decode of the same codes: bf16 through 17 conv
# stages rounded at other points
DECODE_REL_L2_TOL = 0.05
# one s2a micro-batch (B8 x 768, bf16 autocast) through K3+K4 against the
# same step through the plain attention: the flattened trainable gradient's
# relative l2 (measured 0.0039 on an H100; dk scaled by sqrt(D) in K4 gives
# 0.25) and the loss's relative difference (measured 2.3e-6)
TRAIN_GRAD_REL_L2_TOL = 0.02
TRAIN_LOSS_REL_TOL = 1e-3
# the s2a training recipe (configs/injection_conformer/train_config.yaml)
# cut to 6 steps with a 2-step warmup, on 48 seeded items of 800-1000 frames
TRAIN_STEPS = 6
TRAIN_ITEMS = 48
# the t2s recipe (configs/text_to_semantic_w_length/train_config.yaml) on
# more seeded items than length_bucketed's 2048-item pool, so its batches
# are length buckets
T2S_TRAIN_ITEMS = 2100
# gradient checkpointing: one s2a micro-batch with dropout under each
# policy against no remat; the recompute repeats the forward's arithmetic
# and dropout masks, so the gradients agree to the bit unless a policy or
# the dropout generator's restore is wrong
REMAT_DROPOUT = 0.1
REMAT_GRAD_REL_L2_TOL = 1e-3
# (g): the tokenizer through the kernels against the same bf16 models through
# the plain versions on the card. The encoder latents' and HuBERT's layer-18
# states' relative l2; the share of frames whose semantic id and level-0 code
# agree (a CPU proxy at hidden 256, 18 layers, puts bf16 against f32 at a
# relative l2 of 0.013 with 96 % of the ids and 99.6 % of the level-0 codes
# equal; the kernels and the plain versions, both bf16, round at fewer
# points than that, and the limits leave room for the near ties of a
# random init); the batched path's ids, and its codes of all levels over
# all frames but the last (which sees the canvas's padding), against each
# row's exact-size call (the same kernels on the same row; the codec's
# strided convs may take another cuDNN algorithm at B4)
TOKENIZE_REL_L2_TOL = 2e-2
TOKENIZE_SEMANTIC_SAME = 0.9
TOKENIZE_ACOUSTIC_SAME = 0.95
BATCH_SEMANTIC_SAME = 0.9
BATCH_ACOUSTIC_SAME = 0.9
# the batched path's prompts (seconds at 24 kHz)
BATCH_PROMPT_SECONDS = (3.0, 5.5, 8.0, 10.0)
# (f): timed runs per (variant, query tile) of the profiling script's sweep
ABLATION_RUNS = 10
# (i): one s2a micro-batch (B8 x 768, f32, TF32 off) through K3-f32 + K4-f32
# against the same step through the plain f32 attention: each kernel call
# is ~1e-6 off its plain version, which 16 layers and the backward leave
# far under 1e-4 of the flattened gradient and 1e-5 of the loss; an operand
# rounded to TF32 or bf16 moves them by 1e-3 or more, dk scaled by sqrt(D)
# by ~0.25. The remat policies at f32 recompute the same arithmetic, so
# their gradients are held to the same limit. Set before the first run.
TRAIN_F32_GRAD_REL_L2_TOL = 1e-4
TRAIN_F32_LOSS_REL_TOL = 1e-5
# (i): the s2a and t2s recipes at f32 (bf16: false) cut to 3 steps
TRAIN_F32_STEPS = 3
# (i): the tracker the f32 s2a run names in its recipe (a module of the port)
TRACKER_SPEC = "edm_tts_tpu_torch.utils.trackers:make_tracker"
# (j): offline preprocessing on seeded audio: a LibriSpeech-layout set of
# 3-15 s utterances for hubert_kmeans and a LibriLight-layout set of two
# 4-minute books, 8 windows of 60 s, for dump_tokens' default batch of 8
PREPROCESS_UTTERANCES = 40
LIBRILIGHT_BOOK_SECONDS = 240.0
DUMP_WINDOW_SECONDS = 60.0
DUMP_BATCH = 8
# (j): the k-means fit at hubert_kmeans' default size (K 1024 x 1000 frames
# per cluster, D 1024, niter 20, nredo 5). Lloyd's inertia never rises in
# exact arithmetic; the f32 three-term distances over D 1024 may move a
# converged run's sum by ~1e-7 relative. Set before the first run.
KMEANS_INERTIA_RISE_TOL = 1e-5
KMEANS_K, KMEANS_DIM, KMEANS_FRAMES_PER_CLUSTER = 1024, 1024, 1000
# (k): codec GAN training through ``python -m edm_tts_tpu_torch.train.run_codec``
# on a copy of configs/dac/train_config.yaml (CODEC_RECIPE; the card's machine
# has no PyYAML, so the script carries the recipe, pinned equal to the file by
# tests/test_torch_gan.py, and writes it as JSON) cut to CODEC_TRAIN_STEPS
# steps with one eval and one save at the last, then resumed to
# CODEC_RESUME_STEPS; its data: LibriLight-layout seeded books, the recipe's
# 16 held-out windows (CODEC_VAL_BOOK_SECONDS each) and CODEC_TRAIN_BOOKS
# windows of 60 s (157 segments of 0.38 s each)
CODEC_TRAIN_STEPS, CODEC_RESUME_STEPS = 4, 6
CODEC_VAL_BOOK_SECONDS = 5.5
CODEC_TRAIN_BOOKS = 2
CODEC_RECIPE = {
    "output_dir": "exp/edm_tts/dac",
    "generator_args": {"sample_rate": 16000, "encoder_dim": 64, "encoder_rates": [2, 4, 5, 8],
                       "decoder_dim": 1536, "decoder_rates": [8, 5, 4, 2], "n_codebooks": 12,
                       "codebook_size": 1024, "codebook_dim": 8, "quantizer_dropout": 0.5},
    "discriminator_args": {"sample_rate": 16000, "rates": [], "periods": [2, 3, 5, 7, 11],
                           "fft_sizes": [2048, 1024, 512],
                           "bands": [[0.0, 0.1], [0.1, 0.25], [0.25, 0.5], [0.5, 0.75],
                                     [0.75, 1.0]]},
    "gen_optimizer_args": {"lr": 0.0001, "betas": [0.8, 0.99]},
    "disc_optimizer_args": {"lr": 0.0001, "betas": [0.8, 0.99]},
    "gen_scheduler_args": {"gamma": 0.999996},
    "disc_scheduler_args": {"gamma": 0.999996},
    "waveform_args": None,
    "multi_scale_stft_args": None,
    "mel_spectrogram_args": {"n_mels": [5, 10, 20, 40, 80, 160, 320],
                             "window_lengths": [32, 64, 128, 256, 512, 1024, 2048],
                             "mel_fmin": [0, 0, 0, 0, 0, 0, 0], "mel_fmax": [None] * 7,
                             "power": 1.0, "clamp_eps": 1.0e-5, "mag_weight": 0.0},
    "lambdas": {"mel/loss": 15.0, "adv/feat_loss": 2.0, "adv/gen_loss": 1.0,
                "vq/commitment_loss": 0.25, "vq/codebook_loss": 1.0},
    "preprocessing_only": False,
    "dataset_args": {"path": "librilight", "name": "all", "data_dir": "data/libri-light/unlab"},
    "training_segment_length": 0.38,
    "silence_threshold": -40,
    "volume_normalize": -16,
    "validation_segment_length": 5.0,
    "validation_split": 16,
    "shuffle_buffer_size": 10000,
    "seed": 42,
    "per_device_train_batch_size": 32,
    "max_steps": 100000,
    "save_steps": 10000,
    "eval_steps": 1000,
    "logging_steps": 100,
}
# (k): the exported codec's bf16 round trip and the K1/K2 gradient check run
# on one seeded clip of this length (100 frames)
CODEC_CLIP_SECONDS = 2.0
# (k): K1 and K2 under autograd (the kernel's forward, the plain
# composition's VJP as the backward) against the same bf16 model with the
# plain versions swapped in: the flattened gradient's relative l2, K3+K4's
# TRAIN_GRAD_REL_L2_TOL (set before the first run, which measured 0.0141).
# That run also held each tensor to 0.02, and measured
# 0.0254 at worst (median 0.013): a noise-floor run then put the plain bf16
# composition itself 0.0306 at worst from the same model's f32 gradient
# (median 0.0138, flattened 0.0137; kernels 0.0271, 0.0127, 0.0125). So
# each tensor is held to the f32 gradient instead: the kernel path's
# distance at most CODEC_GRAD_NOISE_FACTOR times the plain bf16
# composition's plus CODEC_GRAD_NOISE_FLOOR. A planted fault of K1's
# backward (its recomputation with alpha2 = 1) must land outside.
CODEC_GRAD_REL_L2_TOL = 0.02
CODEC_GRAD_NOISE_FACTOR = 2.0
CODEC_GRAD_NOISE_FLOOR = 2e-3
# the Conformer API (extract_features with output_layer_idx and return_attn)
# on the full-width bf16 t2s: a canvas of API_CANVAS positions in 2 rows, the
# first with its last API_PAD keys masked; the early exit after block
# API_LAYER; each attention map's rows sum to 1 within API_ROW_SUM_TOL (f32
# softmax), and the hidden state of the maps' plain attention agrees with the
# kernels' within REL_L2_TOL
API_CANVAS, API_PAD, API_LAYER = 640, 200, 5
API_ROW_SUM_TOL = 1e-3
# (l): the closed-loop rehearsal (edm_tts_tpu_torch.closed_loop.run) at full
# width in a fresh temporary root: LOOP_SPEAKERS x LOOP_UTTS utterances of
# 3.2-4 s (~21,600 HuBERT frames); HuBERT-large to layer 18 with LOOP_K
# centroids fitted on LOOP_FRAMES_PER_CLUSTER frames per cluster (the CLI's
# default is 1000) in closed_loop.NREDO runs (its default is 5; the JAX
# script's 2);
# the codec of CODEC_RECIPE for LOOP_CODEC_STEPS steps with its one eval,
# save and best_model export at the last step, its held-out windows cut to
# LOOP_SEGMENT_SECONDS (the recipe's 5 s is longer than every utterance); the
# t2s and s2a recipes at f32 for LOOP_STEPS steps each, the s2a's segment cut
# from 15.36 s to LOOP_SEGMENT_SECONDS (the JAX script's); then the JAX
# script's f32 inference with the CLI's 16 + 8 iterations and its length
# (closed_loop.GT_LENGTH, MAX_SPEECH_LEN), and a bf16 --quantize int8
# --one_shot run on the same directories
LOOP_SPEAKERS, LOOP_UTTS = 4, 30
LOOP_K, LOOP_FRAMES_PER_CLUSTER = 1024, 20
LOOP_CODEC_STEPS, LOOP_STEPS = 2, 6
LOOP_SEGMENT_SECONDS = 2.0

KERNELS = {
    "resunit": dict(source="edm_tts_tpu_torch/csrc/resunit.cu",
                    replaces="edm_tts_tpu/ops/pallas_resunit.py:190"),
    "decoder_block": dict(source="edm_tts_tpu_torch/csrc/decoder_block.cu",
                          replaces="edm_tts_tpu/ops/pallas_decoder_block.py:287"),
    "attention": dict(source="edm_tts_tpu_torch/csrc/attention.cu",
                      replaces="edm_tts_tpu/ops/pallas_attention.py:83"),
    "attention_bwd": dict(source="edm_tts_tpu_torch/csrc/attention_bwd.cu",
                          replaces="edm_tts_tpu/ops/pallas_attention.py:234"),
    "int8_dense": dict(source="edm_tts_tpu_torch/csrc/qdense.cu",
                       replaces="edm_tts_tpu/ops/qdense.py:102"),
    "attn_variants": dict(source="edm_tts_tpu_torch/csrc/attn_variants.cu",
                          replaces="scripts/profile_attn_variants.py:55"),
    "attention_f32": dict(source="edm_tts_tpu_torch/csrc/attention_f32.cu",
                          replaces="edm_tts_tpu/ops/pallas_attention.py:83"),
    "int8_dense_f32": dict(source="edm_tts_tpu_torch/csrc/qdense_f32.cu",
                           replaces="edm_tts_tpu/ops/qdense.py:102"),
    "attention_bwd_f32": dict(source="edm_tts_tpu_torch/csrc/attention_bwd_f32.cu",
                              replaces="edm_tts_tpu/ops/pallas_attention.py:234"),
}
# K3's f32 kernel at the f32 path's shapes (ATTENTION_F32_CASES:
# profile_attention_f32.CASES, HuBERT-large on a 3 s and a 10 s prompt and
# its masked batch, the t2s canvas, the s2a at one request and at a full
# canvas) and, with K3 and K4 in bf16 and K4-f32, at the training shapes
# (ATTENTION_TRAIN_CASES: profile_attention_f32.TRAIN_CASES, the s2a
# micro-batch, a masked ragged batch, the masked t2s canvas); and at an
# edge case (label: B, T, H, D, per row the valid key ranges): D 40 (DP 64,
# the k-steps past D skipped), row 0's keys 128-191 wholly masked between
# valid ones, row 1 without a valid key (uniform attention)
ATTENTION_F32_EDGE_CASE = ("edge B2 T300 H4 D40 hole, a row without valid keys",
                           (2, 300, 4, 40, (((0, 70), (200, 260)), ())))
# K3 with its LSE and K4, in bf16 and in f32, also at GPipe's shapes: path
# (n)'s microbatch (B2 of its B8, bf16) and the dry run's tiny s2a step
# (leg 1 on the card, f32)
PIPE_ATTENTION_CASES = (("s2a pipe microbatch B2 T768 H16 D64", (2, 768, 16, 64, None)),
                        ("dry run s2a B2 T32 H4 D32", (2, 32, 4, 32, None)))
# --source-faults: faults planted in copies of the kernels' CUDA sources,
# each of which the cases of its kernels must reject (K1's and K2's under
# --codec-kernels, K5's under --int8-kernels, K3's, K4's and K6's under
# --attention-kernels). name: (source in edm_tts_tpu_torch/csrc, [(text,
# replacement), ...]); every occurrence is replaced
SOURCE_FAULTS = {
    "delta dropped": ("attention_bwd.cu", [
        ("(dpt[n][e] - del)", "(dpt[n][e])"),
        ("(dp[n][e] - dl[e >> 1])", "(dp[n][e])")]),
    "dk without the scale": ("attention_bwd.cu", [
        ("dpt[n][e] = p * (dpt[n][e] - del) * scd;", "dpt[n][e] = p * (dpt[n][e] - del);")]),
    "mask ignored in the backward": ("attention_bwd.cu", [
        ("scan_key_tiles<kBwdWarps>(mask,", "scan_key_tiles<kBwdWarps>(nullptr,")]),
    "last query tile skipped": ("attention_bwd.cu", [
        ("const int nqt = (Tq + kTileRows - 1) / kTileRows;",
         "const int nqt = (Tq - 1) / kTileRows;")]),
    "LSE without log(l)": ("attention.cu", [("(m[r] + log2f(l[r])) * kLn2", "m[r] * kLn2")]),
    # the pipeline: a TMA coordinate one tile off (K in K3, V in K4's dq kernel)
    "K3's K tile copied one tile off": ("attention.cu", [
        ("&kmap, bar, 0, h, live[i] * kTileRows, b);",
         "&kmap, bar, 0, h, (live[i] + 1) * kTileRows, b);")]),
    "K4's dq V tile copied one tile off": ("attention_bwd.cu", [
        ("&vmap, bar, 0, h, live[i] * kTileRows, b);",
         "&vmap, bar, 0, h, (live[i] + 1) * kTileRows, b);")]),
    "K6 online rescale dropped": ("attn_variants.cu", [
        ("alpha[r] = ex2_f32(m[r] - m_new);", "alpha[r] = 1.0f;")]),
    "K6 noexp without m * colsum(V)": ("attn_variants.cu", [
        ("x0 -= m[r] * vacc[n][2 * r];", ""), ("x1 -= m[r] * vacc[n][2 * r + 1];", "")]),
    # the pipeline: K's TMA coordinate one tile off
    "K6's K tile copied one tile off": ("attn_variants.cu", [
        ("&kmap, bar, 0, h, i * kTileRows, b);", "&kmap, bar, 0, h, (i + 1) * kTileRows, b);")]),
    "K5 scale ignored": ("qdense.cu", [
        ("const float sc0 = scale[n], sc1 = scale[n + 1];", "const float sc0 = 1.0f, sc1 = 1.0f;")]),
    "K5 int8 read as unsigned": ("qdense.cu", [
        ("const uint32_t bias = (p & 0x00800080u) | 0x43004300u;",
         "const uint32_t bias = 0x43004300u;")]),
    "K5 last K tile skipped": ("qdense.cu", [
        ("const int nk_all = (K + kQK - 1) / kQK", "const int nk_all = (K - 1) / kQK")]),
    "K5 ragged last M tile not stored": ("qdense.cu", [
        ("if (m >= M) continue;", "if (m >= M / BM * BM) continue;")]),
    # the split K: each block adds only the first block's sums
    "K5 split sums of the other blocks dropped": ("qdense.cu", [
        ("for (int r = 0; r < splits; ++r) {", "for (int r = 0; r < 1; ++r) {")]),
    # the pipeline: the weight tile read without the copy engine's swizzle
    "K5 weight bytes read unswizzled": ("qdense.cu", [
        ("((((col >> 4) ^ (r & 7))) << 4)", "((col >> 4) << 4)")]),
    # K1 (the GEMM body in conv_gemm.cuh, shared with K2): the last tap's A
    # tile one row late, in the dilated conv only
    "K1 a tap's row coordinate off by one": ("conv_gemm.cuh", [
        ("t0 + (tap - TAPS / 2) * dil, b);", "t0 + (tap - TAPS / 2) * dil + (tap == 6), b);")]),
    "K1 b7 dropped": ("conv_gemm.cuh", [
        ("bi[j] = bias[n + j];", "bi[j] = EPI == kConv7 ? 0.0f : bias[n + j];")]),
    "K1 alpha2 ignored": ("conv_gemm.cuh", [("al[j] = alpha[n + j];", "al[j] = 1.0f;")]),
    "K1 last N tile not stored": ("conv_gemm.cuh", [
        ("if (threadIdx.x >= kRowStep * kChunks || n >= N) return;",
         "if (threadIdx.x >= kRowStep * kChunks || n >= N ||\n"
         "      (EPI == kConv1 && blockIdx.x + 1 == gridDim.x)) return;")]),
    "K1 residual dropped": ("conv_gemm.cuh", [
        ("v[2 * j] += bi[2 * j] + x2.x;", "v[2 * j] += bi[2 * j];"),
        ("v[2 * j + 1] += bi[2 * j + 1] + x2.y;", "v[2 * j + 1] += bi[2 * j + 1];")]),
    # the pipeline: tiles copied unswizzled while wgmma reads them swizzled
    "K1 swizzle read wrong": ("conv_gemm.cuh", [
        ("CU_TENSOR_MAP_SWIZZLE_128B", "CU_TENSOR_MAP_SWIZZLE_NONE")]),
    # K2's phase product: its last tap's A tile one row late
    "K2 a tap's row coordinate off by one": ("conv_gemm.cuh", [
        ("t0 + (tap - TAPS / 2) * dil, b);",
         "t0 + (tap - TAPS / 2) * dil + (EPI == kPhase && tap == 2), b);")]),
    # the tap skip: each half runs the other half's tap pair
    "K2 the halves' tap pairs swapped": ("conv_gemm.cuh", [
        ("tap0 = n0 >= half ? 1 : 0;", "tap0 = n0 >= half ? 0 : 1;")]),
    # bias3 read as if it held one phase's bias: the upper phases get none
    "K2 bias not tiled": ("conv_gemm.cuh", [
        ("bi[j] = bias[n + j];", "bi[j] = EPI == kPhase && n >= half ? 0.0f : bias[n + j];")]),
    "K2 last row tile not stored": ("conv_gemm.cuh", [
        ("for (int r = threadIdx.x / kChunks; r < kConvBM && t0 + r < T; r += kRowStep) {",
         "for (int r = threadIdx.x / kChunks; r < kConvBM && t0 + r < T &&\n"
         "       !(EPI == kPhase && blockIdx.y + 1 == gridDim.y); r += kRowStep) {")]),
}
SOURCE_FAULTS.update({
    # K3's f32 kernel: the online rescale, the mask, the last partial key
    # tile, the lo·hi term of Q Kᵀ, the streamed lo parts (K's and V's)
    # zeroed after the block's split, V^T's keys stored in their own order
    # instead of P's accumulator column order, the uniform row's scale
    "K3 f32 online rescale dropped": ("attention_f32.cu", [
        ("alpha[r] = ex2_f32(m[r] - mx[r]);", "alpha[r] = m[r] == -INFINITY ? 0.0f : 1.0f;")]),
    "K3 f32 mask ignored": ("attention_f32.cu", [
        ("scan_key_tiles<4 * NWG>(mask,", "scan_key_tiles<4 * NWG>(nullptr,")]),
    "K3 f32 last partial key tile dropped": ("attention_f32.cu", [
        ("live, live + nkt, &uniform);",
         "live, live + nkt, &uniform) -\n"
         "      (Tk % kTileRows != 0 && kbits[nkt - 1] != 0);")]),
    "K3 f32 lo·hi term of Q Kᵀ dropped": ("attention_f32.cu", [
        ("WgmmaTF32SS64::run(sa, qlo, khi, 1);", "")]),
    "K3 f32 streamed lo parts zeroed": ("attention_f32.cu", [
        ("split_vt<DP>(st + L::kTile, st + 3 * L::kTile, st + 4 * L::kTile);",
         "split_vt<DP>(st + L::kTile, st + 3 * L::kTile, st + 4 * L::kTile);\n"
         "    for (int z = threadIdx.x * 16; z < L::kTile; z += blockDim.x * 16) {\n"
         "      *reinterpret_cast<uint4*>(st + 2 * L::kTile + z) = make_uint4(0, 0, 0, 0);\n"
         "      *reinterpret_cast<uint4*>(st + 4 * L::kTile + z) = make_uint4(0, 0, 0, 0);\n"
         "    }\n"
         "    fence_proxy_async();")]),
    "K3 f32 P's column order not matched": ("attention_f32.cu", [
        ("const int p = (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);", "const int p = r;")]),
    "K3 f32 uniform row's scale not zeroed": ("attention_f32.cu", [
        ("const float sc = uniform ? 0.0f : scale * kLog2e;", "const float sc = scale * kLog2e;")]),
    # K5's f32 kernel: the scale, the last K step, the ragged rows, the
    # split (its x_lo product, its cluster sums), the widening and the
    # swizzle of the widened weight that the warpgroup MMA reads
    "K5 f32 scale ignored": ("qdense_f32.cu", [
        ("const float sc0 = scale[n], sc1 = scale[n + 1];", "const float sc0 = 1.0f, sc1 = 1.0f;")]),
    "K5 f32 last K step skipped": ("qdense_f32.cu", [
        ("const int nk_all = K / kF32QK", "const int nk_all = (K - 1) / kF32QK")]),
    "K5 f32 ragged last row tile not stored": ("qdense_f32.cu", [
        ("if (m >= M) continue;", "if (m >= M / BM * BM) continue;")]),
    "K5 f32 x_lo product dropped": ("qdense_f32.cu", [
        ("WgmmaTF32<NW>::run(sum, lo[j], desc + 2 * j, 1);", "")]),
    "K5 f32 split sums of the other blocks dropped": ("qdense_f32.cu", [
        ("for (int r = 0; r < splits; ++r) {", "for (int r = 0; r < 1; ++r) {")]),
    "K5 f32 int8 read as unsigned": ("qdense_f32.cu", [
        ("r * kF32QBN) ^ 0x80808080u;", "r * kF32QBN);")]),
    "K5 f32 widened weight stored unswizzled": ("qdense_f32.cu", [
        ("((warp ^ (n & 7)) << 4)", "(warp << 4)")]),
    # K4's f32 kernel: delta left out of ds (both kernels), the mask ignored
    # (both kernels), the dq kernel's last key tile left out, a term of the
    # split products dropped, the accumulators' column order not matched
    # (the design's stand-in for a quad shuffle: the B rows of P^T's products
    # read in m16n8k8's own order); and in the staging it shares with K3-f32
    # (attn_f32.cuh): the streamed tiles' lo parts dropped by the block's
    # split, a staged tile read unswizzled
    "K4 f32 delta dropped": ("attention_bwd_f32.cu", [
        ("pt[n][e] * (dst[n][e] - ((e & 1) ? dz.y : dz.x)) * scd", "pt[n][e] * dst[n][e] * scd"),
        ("p * (dp[n][e] - dl[e >> 1]) * scd", "p * dp[n][e] * scd")]),
    "K4 f32 mask ignored": ("attention_bwd_f32.cu", [
        ("scan_key_tiles<W::kWarps>(mask,", "scan_key_tiles<W::kWarps>(nullptr,")]),
    "K4 f32 last key tile skipped": ("attention_bwd_f32.cu", [
        ("    mm_pt<DP>(dqa, sa, smem + (ks - sbase),",
         "    if (i + 1 < nlive) mm_pt<DP>(dqa, sa, smem + (ks - sbase),")]),
    "K4 f32 lo·hi term dropped": ("attention_bwd_f32.cu", [
        ("if (n < n_use) mma1688(c[n], al, bh[n][0], bh[n][1]);", ";")]),
    "K4 f32 Pᵀ quad shuffle wrong": ("attention_bwd_f32.cu", [
        ("8 * j + 2 * tg, 8 * n + g)", "8 * j + tg, 8 * n + g)"),
        ("8 * j + 2 * tg + 1, 8 * n + g)", "8 * j + tg + 4, 8 * n + g)")]),
    "K4 f32 streamed lo parts dropped": ("attn_f32.cuh", [
        ("*reinterpret_cast<uint4*>(lo + o) = l;",
         "*reinterpret_cast<uint4*>(lo + o) = make_uint4(0, 0, 0, 0);")]),
    "K4 f32 streamed tile read unswizzled": ("attn_f32.cuh", [
        ("((((c & 31) >> 2) ^ (r & 7)) << 4)", "(((c & 31) >> 2) << 4)")]),
})
# the --source-faults mode of each fault's source
FAULT_MODES = {"conv_gemm.cuh": "--codec-kernels", "qdense.cu": "--int8-kernels",
               "attention_f32.cu": "--f32-kernels", "qdense_f32.cu": "--f32-kernels",
               "attention_bwd_f32.cu": "--f32-kernels", "attn_f32.cuh": "--f32-kernels"}


class CheckFailed(SystemExit):
    """A result outside its limit: exit code 1 (3 under ``--attention-kernels``,
    ``--int8-kernels``, ``--codec-kernels``, ``--f32-kernels`` and
    ``--closed-loop``)."""


def fail(msg: str) -> None:
    raise CheckFailed(f"chip_smoke: FAIL: {msg}")


def rel_l2(torch, out, ref) -> float:
    return ((out.float() - ref.float()).norm() / ref.float().norm()).item()


def parent_f32_kernels(torch, checkout):
    """K3-f32 and K4-f32 of another checkout, built from its
    csrc/attention_f32.cu and csrc/attention_bwd_f32.cu into the build
    directory, with their wrappers' work as of the parent of the K3-f32
    redesign (the FFMA K3-f32 and its D % 4 padding; K4-f32 with lse and
    delta rows padded to a multiple of 4): ``{"attention_f32": fn(q, k, v,
    mask) -> (o, lse), "attention_bwd_f32": fn(q, k, v, mask, o, lse, g)}``."""
    import ctypes
    import hashlib

    from edm_tts_tpu_torch.kernels.build import BUILD_DIR, build_sources, check_launch
    from edm_tts_tpu_torch.ops.attention import _padded_rows, pad_depth

    srcs = [checkout / "edm_tts_tpu_torch" / "csrc" / f for f in ("attention_f32.cu",
                                                                  "attention_bwd_f32.cu")]
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in srcs)).hexdigest()[:16]
    lib = ctypes.CDLL(str(build_sources(srcs, BUILD_DIR / f"libparent_f32_{digest}.so")))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.edm_attention_f32.argtypes = [ptr] * 6 + [i32] * 5 + [ctypes.c_float, ptr]
    lib.edm_attention_bwd_f32.argtypes = [ptr] * 10 + [i32] * 5 + [ctypes.c_float, ptr]
    lib.edm_attention_f32.restype = lib.edm_attention_bwd_f32.restype = ctypes.c_int

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fwd(q, k, v, mask):
        b, tq, h, d = q.shape
        dp = -(-d // 4) * 4
        q, k, v = (pad_depth(x, dp).contiguous() for x in (q, k, v))
        out = torch.empty_like(q)
        lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
        check_launch(lib.edm_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, tq, k.shape[1], h, dp, d ** -0.5, stream()),
            "parent edm_attention_f32")
        return out[..., :d], lse

    def bwd(q, k, v, mask, o, lse, g):
        b, tq, h, d = q.shape
        lse_p, delta = _padded_rows(lse, (g * o).sum(-1), b, h, tq)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        check_launch(lib.edm_attention_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            None if mask is None else mask.data_ptr(), lse_p.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, tq, k.shape[1], h, d, d ** -0.5,
            stream()), "parent edm_attention_bwd_f32")
        return dq, dk, dv

    return {"attention_f32": fwd, "attention_bwd_f32": bwd}


def kernel_phase(torch, ops, part: str | None = None, parent_front=None,
                 parent_f32=None) -> dict:
    """Each kernel against its plain version at the slices' shapes; with
    ``part`` "attention" only K3 with its LSE, K4 and K6's ragged cases, with
    "int8" only K5's cases, with "codec" only K1's one-request cases and
    K2's, with "f32" only the f32 kernels' cases (what ``--source-faults``
    needs). ``parent_front``: another
    checkout's K2 front (profile_decoder_block.parent_front), timed beside
    this one's; ``parent_f32``: another checkout's K3-f32 and K4-f32
    (parent_f32_kernels), timed beside these ("was_ms").

    Alphas are drawn U(0.5, 2), biases N(0, 0.5) and the int8 weights'
    column magnitudes U(0.5, 2), so that every term of the arithmetic moves
    the output by more than the limit.
    """
    import torch.nn.functional as F

    from edm_tts_tpu_torch.ops import ring_attention
    from edm_tts_tpu_torch.ops.attn_variants import BLOCK_Q, VARIANTS, attn_variant_reference
    from edm_tts_tpu_torch.profile_attention_f32 import CASES as ATTENTION_F32_CASES
    from edm_tts_tpu_torch.profile_attention_f32 import TRAIN_CASES as ATTENTION_TRAIN_CASES
    from edm_tts_tpu_torch.profile_attention_f32 import work as attention_f32_work
    from edm_tts_tpu_torch.ops.decoder_block import phase_weights
    from edm_tts_tpu_torch.profile_attn_variants import SHAPE
    from edm_tts_tpu_torch.profile_attn_variants import work as variant_work
    from edm_tts_tpu_torch.profile_decoder_block import CASES as DECODER_BLOCK_CASES
    from edm_tts_tpu_torch.profile_decoder_block import front_work
    from edm_tts_tpu_torch.profile_qdense import CASES as INT8_CASES
    from edm_tts_tpu_torch.profile_qdense import SERVED_CASES as SERVED_INT8_CASES
    from edm_tts_tpu_torch.profile_qdense import int8_work
    from edm_tts_tpu_torch.profile_resunit import CASES as RESUNIT_CASES
    from edm_tts_tpu_torch.profile_resunit import ENCODER_CASES
    from edm_tts_tpu_torch.profile_resunit import ONE_ROW_CASES as ONE_ROW_RESUNIT_CASES
    from edm_tts_tpu_torch.profile_resunit import SERVED_CASES as SERVED_RESUNIT_CASES
    from edm_tts_tpu_torch.profile_decoder_block import decoder_blocks
    from edm_tts_tpu_torch.profile_resunit import decoder_units, encoder_units, resunit_work
    from edm_tts_tpu_torch.profile_tokenization import PROMPT_SECONDS, encoder_samples
    from edm_tts_tpu_torch.utils.devtime import (PEAK_2XTF32_FLOPS, PEAK_3XTF32_FLOPS,
                                                  bound, median_ms)

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def tile(b, h, t):  # K3's query rows per block at this launch
        return f"block_q {ops.attention.attention_query_tile(b, h, t, sms)}"

    def normal(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def uniform(*shape, lo, hi):
        return lo + torch.rand(*shape, generator=gen, device=dev) * (hi - lo)

    def alpha(c):
        return uniform(c, lo=0.5, hi=2.0)

    def resunit_params(c):
        """(alpha1, w7, b7, alpha2, w1, b1) as K1 takes them."""
        b7 = (7 * c) ** -0.5
        return (alpha(c), uniform(7, c, c, lo=-b7, hi=b7).to(bf16), normal(c, scale=0.5),
                alpha(c), uniform(1, c, c, lo=-c ** -0.5, hi=c ** -0.5).to(bf16),
                normal(c, scale=0.5))

    def tf32(x):  # x with its mantissa cut to TF32's 10 bits
        return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)

    def replaced(params, i, value):
        return tuple(value if j == i else p for j, p in enumerate(params))

    cases: dict[str, list] = {name: [] for name in KERNELS}

    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def compare(name, label, kernel, plain, faults, work, library=None,
                tols=(REL_L2_TOL, MAX_ABS_TOL), was=None):
        """``work``: (operations, bytes[, exponentials[, peak FLOP/s]]) the
        function needs on these inputs (f32 kernels: a split-TF32 rate);
        ``tols``: (relative l2, max abs share) limits;
        ``library``: (name, fn) of one PyTorch call computing it, or None,
        or (name, fn, fn_subtracted): the time of the first less the second;
        ``was``: another checkout's kernel on the same inputs, timed beside.
        A function of several outputs (K3 with its LSE, K4) is held to the
        limits on each; a fault is rejected when any output leaves them."""
        rel_tol, abs_share = tols
        out = as_tuple(kernel())
        torch.cuda.synchronize()
        ref = as_tuple(plain())
        torch.cuda.synchronize()
        for o, r in zip(out, ref):
            if o.shape != r.shape or not torch.isfinite(o).all():
                fail(f"{label}: shape {tuple(o.shape)} vs {tuple(r.shape)} or non-finite output")
        errs = [(o.float() - r.float()).abs().max().item() for o, r in zip(out, ref)]
        abs_tols = [abs_share * r.float().abs().max().item() for r in ref]
        err, max_abs_tol = max(errs), max(abs_tols)
        rel = max(rel_l2(torch, o, r) for o, r in zip(out, ref))
        fault_rel = {f: max(rel_l2(torch, o, r) for o, r in zip(as_tuple(fn()), ref))
                     for f, fn in faults.items()}
        ms, plain_ms = median_ms(kernel), median_ms(plain)
        library_ms = None
        if library is not None:
            library_ms = median_ms(library[1])
            if len(library) == 3:
                library_ms -= median_ms(library[2])
        was_ms = None if was is None else median_ms(was)
        bound_ms, bound_by = bound(*work)
        print(f"kernel {name} {label}: rel_l2 {rel:.6g} (tol {rel_tol:.6g}) max_abs_err "
              f"{err:.6g} (tol {max_abs_tol:.4g}) planted faults rel_l2 "
              f"{ {f: round(r, 5) for f, r in fault_rel.items()} } "
              f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
              f"{'n/a' if library_ms is None else f'{library_ms:.4f} ({library[0]})'} "
              f"bound_ms {bound_ms:.4f} ({bound_by})"
              f"{'' if was_ms is None else f' was_ms {was_ms:.4f} (parent)'}", flush=True)
        if not (rel <= rel_tol and all(e <= t for e, t in zip(errs, abs_tols))):  # NaN fails too
            fail(f"{label}: rel l2 {rel} / max abs {err} above {rel_tol} / {max_abs_tol}")
        weak = [f for f, r in fault_rel.items() if not r > rel_tol]
        if weak:
            fail(f"{label}: the limit would let the planted faults {weak} pass")
        cases[name].append(dict(case=label, rel_l2=rel, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, library_ms=library_ms,
                                library=None if library is None else library[0],
                                bound_ms=bound_ms, bound_by=bound_by,
                                planted_fault_rel_l2=fault_rel,
                                **({} if was_ms is None else {"was_ms": was_ms})))

    # K3's and K5's f32 kernels (also under --f32-kernels): K3 at
    # ATTENTION_F32_CASES and ATTENTION_F32_EDGE_CASE with its LSE (and at
    # ATTENTION_TRAIN_CASES below), K5 at every int8 case of one request
    # and of a served call, f32 activations. Faults: an operand rounded to
    # bf16 or to TF32, and each kernel's own (mask, tail keys, the uniform
    # row's scale; scale, last K step). Library calls: SDPA on f32 inputs,
    # f32 matmul on the dequantized weight (TF32 off for both). Bound:
    # f32-accurate products at the split-TF32 rate (3xTF32 for K3, 2xTF32
    # for K5: its weight is exact).
    for label, m, kdim, n in INT8_CASES + SERVED_INT8_CASES if part in (None, "f32") else ():
        x = normal(m, kdim)
        q8, scale = ops.quantize_weight(normal(kdim, n) * uniform(n, lo=0.5, hi=2.0))
        w_deq = q8.float() * scale
        compare("int8_dense_f32", f"{label} M{m} K{kdim} N{n}",
                lambda: ops.int8_dense(x, q8, scale),
                lambda: ops.int8_dense_reference(x, q8, scale),
                {"bf16 x": lambda: ops.int8_dense_reference(x.to(bf16).float(), q8, scale),
                 "tf32 x": lambda: ops.int8_dense_reference(tf32(x), q8, scale),
                 "scale ignored": lambda: x @ q8.float(),
                 "last K step dropped": lambda: ops.int8_dense_reference(
                     x[:, :-16], q8[:-16], scale)},
                (*int8_work(m, kdim, n, 4), 0, PEAK_2XTF32_FLOPS),
                ("matmul f32-dequantized, TF32 off", lambda: torch.matmul(x, w_deq)),
                tols=(F32_REL_L2_TOL, F32_MAX_ABS_TOL))
        cases["int8_dense_f32"][-1].update(m=m, k=kdim, n=n,
                                           tile=ops.qdense.int8_dense_f32_tile(m, kdim, n, sms))

    def key_mask(b, t, lens):
        """None, or bool (B, T): per row a key length or the valid key ranges."""
        if lens is None:
            return None
        pos = torch.arange(t, device=dev)
        mask = torch.zeros(b, t, dtype=torch.bool, device=dev)
        for row, keys in enumerate(lens):
            for start, stop in ((0, keys),) if isinstance(keys, int) else keys:
                mask[row] |= (pos >= start) & (pos < stop)
        return mask

    def attention_f32_case(label, q, k, v, mask):
        b, t, h, d = q.shape
        pos = torch.arange(t, device=dev)[None]
        # the keys the kernel counts: a row without a valid key counts them all
        valid = pos.expand(b, t) >= 0 if mask is None else mask | ~mask.any(-1, keepdim=True)
        tail = valid & (pos < t // 64 * 64)

        def plain_lse(q=q, k=k, v=v, mask=mask):
            return ops.mha_reference(q, k, v, mask=mask), ops.attention_lse_reference(q, k, mask=mask)

        faults = {"bf16 operands": lambda: plain_lse(*(z.to(bf16).float() for z in (q, k, v))),
                  "tf32 q and k": lambda: plain_lse(tf32(q), tf32(k))}
        if not torch.equal(tail, valid):  # the last tile holds a key that counts
            faults["tail tile dropped"] = lambda: plain_lse(mask=tail)
        if mask is not None:
            faults["mask ignored"] = lambda: plain_lse(mask=None)
        if not torch.equal(valid, pos.expand(b, t) >= 0 if mask is None else mask):
            # a row without a valid key attended with the score scale
            faults["uniform row's scale not zeroed"] = lambda: plain_lse(mask=valid)
        qt, kt, vt = (z.transpose(1, 2).contiguous() for z in (q, k, v))
        sdpa_mask = None if mask is None else mask[:, None, None, :]
        n_keys = int(valid.sum())  # summed over the batch rows
        compare("attention_f32", f"{label} with LSE, block_q "
                f"{ops.attention.attention_f32_query_tile(b, h, t, d, sms)}",
                lambda: ops.flash_mha(q, k, v, mask=mask, return_lse=True), plain_lse, faults,
                (*attention_f32_work(b, t, h, d, n_keys), PEAK_3XTF32_FLOPS),
                ("scaled_dot_product_attention f32", lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=sdpa_mask)),
                tols=(F32_REL_L2_TOL, F32_MAX_ABS_TOL),
                was=None if parent_f32 is None else (
                    lambda: parent_f32["attention_f32"](q, k, v, mask)))
        out, lse = ops.flash_mha(q, k, v, mask=mask, return_lse=True)
        again = ops.flash_mha(q, k, v, mask=mask, return_lse=True)
        lse_err = (lse - ops.attention_lse_reference(q, k, mask=mask)).abs().max().item()
        same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        print(f"kernel attention_f32 {label}: LSE max abs err {lse_err:.4g} (tol "
              f"{F32_LSE_ABS_TOL}); a second call equal to the bit: {same}", flush=True)
        if not lse_err <= F32_LSE_ABS_TOL:
            fail(f"{label}: K3-f32's LSE is off by {lse_err}, above {F32_LSE_ABS_TOL}")
        if not same:
            fail(f"{label}: K3-f32 gave another result on a second call")

    for label, (b, t, h, d, lens) in (
            ATTENTION_F32_CASES + (ATTENTION_F32_EDGE_CASE,) if part in (None, "f32") else ()):
        q, k, v = (normal(b, t, h, d) for _ in range(3))
        attention_f32_case(label, q, k, v, key_mask(b, t, lens))
    # K3-f32 with its LSE and K4's f32 kernel at the bf16 K4's cases
    # (ATTENTION_TRAIN_CASES + PIPE_ATTENTION_CASES, f32 inputs), K4-f32
    # from K3-f32's LSE; the plain version takes the plain LSE.
    # Faults: delta dropped, the mask ignored, the last query tile's dO
    # dropped, q rounded to TF32. Library call: SDPA's f32 backward (forward
    # and backward timed, the forward subtracted). Bound: the five products
    # at the 3xTF32 rate.
    for label, (b, t, h, d, lens) in (ATTENTION_TRAIN_CASES + PIPE_ATTENTION_CASES
                                      if part in (None, "f32") else ()):
        q, k, v, g = (normal(b, t, h, d) for _ in range(4))
        n_keys = [t] * b if lens is None else list(lens)
        mask = key_mask(b, t, lens)
        attention_f32_case(label, q, k, v, mask)
        o, lse = ops.flash_mha(q, k, v, mask=mask, return_lse=True)
        lse_ref = ops.attention_lse_reference(q, k, mask=mask)
        g_cut = g.clone()
        g_cut[:, (t - 1) // 64 * 64:] = 0
        key_work = sum(n_keys) * t * h * d

        def bwd_plain(q=q, mask=mask, o=o, g=g):
            return ops.flash_mha_bwd_reference(q, k, v, mask, o, lse_ref, g)

        faults = {"delta dropped": lambda: bwd_plain(o=torch.zeros_like(o)),
                  "last query tile skipped": lambda: bwd_plain(g=g_cut),
                  "tf32 q": lambda: bwd_plain(q=tf32(q))}
        if mask is not None:
            faults["mask ignored"] = lambda: bwd_plain(mask=None)
        qt, kt, vt = (z.transpose(1, 2).contiguous().requires_grad_() for z in (q, k, v))
        gt = g.transpose(1, 2).contiguous()
        sdpa_mask = None if mask is None else mask[:, None, None, :]

        def sdpa_fwd():
            with torch.enable_grad():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask)

        def sdpa_fwd_bwd():
            with torch.enable_grad():
                return torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), gt)

        compare("attention_bwd_f32", f"{label} f32",
                lambda: ops.flash_mha_bwd(q, k, v, mask, o, lse, g), bwd_plain, faults,
                (10 * key_work, 4 * (8 * b * t * h * d + b * h * t) + b * t,
                 sum(n_keys) * t * h, PEAK_3XTF32_FLOPS),
                ("scaled_dot_product_attention f32 backward", sdpa_fwd_bwd, sdpa_fwd),
                tols=(F32_REL_L2_TOL, F32_MAX_ABS_TOL),
                was=None if parent_f32 is None else (
                    lambda: parent_f32["attention_bwd_f32"](q, k, v, mask, o, lse, g)))
        if mask is not None:  # keys at padded positions get exactly zero dk and dv
            _, dk, dv = ops.flash_mha_bwd(q, k, v, mask, o, lse, g)
            if dk[~mask].any() or dv[~mask].any():
                fail(f"{label}: K4-f32 wrote non-zero dk or dv at padded keys")
    if part == "f32":
        return cases

    # K3 with its LSE and K4 (attention_bwd, both of its kernels) at
    # ATTENTION_TRAIN_CASES + PIPE_ATTENTION_CASES (not under --int8-kernels).
    # The library calls are SDPA with the same bool
    # mask on inputs that require grad: for K3 its forward (which keeps its
    # LSE for the backward), for K4 its backward (forward and backward timed
    # together, the forward subtracted). K4's plain version takes the plain
    # LSE, so an LSE error of K3 also shows in dq, dk and dv.
    for label, (b, t, h, d, lens) in (ATTENTION_TRAIN_CASES + PIPE_ATTENTION_CASES
                                      if part in (None, "attention") else ()):
        q, k, v, g = (normal(b, t, h, d).to(bf16) for _ in range(4))
        mask = None
        n_keys = [t] * b
        if lens is not None:
            mask = torch.arange(t, device=dev)[None] < torch.tensor(lens, device=dev)[:, None]
            n_keys = list(lens)
        o, lse = ops.flash_mha(q, k, v, mask=mask, return_lse=True)
        lse_ref = ops.attention_lse_reference(q, k, mask=mask)
        torch.cuda.synchronize()
        last = (t - 1) // 64 * 64  # the first query row of the last tile
        g_cut = g.clone()
        g_cut[:, last:] = 0
        elems = b * t * h * d
        key_work = sum(n_keys) * t * h * d  # per (query, valid key, head, depth)

        def plain_lse(mask=mask):
            return ops.mha_reference(q, k, v, mask=mask), ops.attention_lse_reference(q, k, mask=mask)

        def cut_last_tile():
            ref_o, ref_lse = plain_lse()
            ref_o = ref_o.clone()
            ref_o[:, last:] = 0
            return ref_o, ref_lse

        faults = {"last query tile skipped": cut_last_tile}
        if mask is not None:
            faults["mask ignored"] = lambda: plain_lse(None)
        qt, kt, vt = (z.transpose(1, 2).contiguous().requires_grad_() for z in (q, k, v))
        gt = g.transpose(1, 2).contiguous()
        sdpa_mask = None if mask is None else mask[:, None, None, :]

        def sdpa_fwd():
            with torch.enable_grad():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask)

        def sdpa_fwd_bwd():
            with torch.enable_grad():
                return torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), gt)

        # SDPA on inputs that require grad keeps its LSE for the backward
        # one exponential per (query, valid key, head): K3's, and K4's to
        # rebuild p (once, as one kernel doing both of K4's parts would)
        exps = sum(n_keys) * t * h
        compare("attention", f"{label} with LSE, {tile(b, h, t)}",
                lambda: ops.flash_mha(q, k, v, mask=mask, return_lse=True), plain_lse, faults,
                (4 * key_work, 4 * elems * 2 + b * t + b * h * t * 4, exps),
                ("scaled_dot_product_attention, inputs requiring grad", sdpa_fwd))
        lse_err = (lse - lse_ref).abs().max().item()
        print(f"kernel attention {label} with LSE: LSE max abs err {lse_err:.4g} "
              f"(tol {LSE_ABS_TOL})", flush=True)
        if not lse_err <= LSE_ABS_TOL:
            fail(f"{label}: K3's LSE is off by {lse_err}, above {LSE_ABS_TOL}")

        def bwd_plain(mask=mask, o=o, g=g):
            return ops.flash_mha_bwd_reference(q, k, v, mask, o, lse_ref, g)

        def dk_unscaled():
            dq, dk, dv = bwd_plain()
            return dq, dk * d ** 0.5, dv

        faults = {"delta dropped": lambda: bwd_plain(o=torch.zeros_like(o)),
                  "dk without the scale": dk_unscaled,
                  "last query tile skipped": lambda: bwd_plain(g=g_cut)}
        if mask is not None:
            faults["mask ignored"] = lambda: bwd_plain(mask=None)
        compare("attention_bwd", label,
                lambda: ops.flash_mha_bwd(q, k, v, mask, o, lse, g), bwd_plain, faults,
                (10 * key_work, 8 * elems * 2 + b * h * t * 4 + b * t, exps),
                ("scaled_dot_product_attention backward", sdpa_fwd_bwd, sdpa_fwd))
        if mask is not None:  # keys at padded positions get exactly zero dk and dv
            _, dk, dv = ops.flash_mha_bwd(q, k, v, mask, o, lse, g)
            if dk[~mask].any() or dv[~mask].any():
                fail(f"{label}: K4 wrote non-zero dk or dv at padded keys")
            print(f"kernel attention_bwd {label}: dk and dv exactly 0 at "
                  f"{int((~mask).sum())} padded keys", flush=True)
    # the ring attention's steps (ops/ring_attention.py) on one card: q
    # against n = 2 and 4 key chunks, K3 with its LSE per chunk merged by
    # the LSEs in f32, then K4 per chunk with the merged output and LSE
    # (chunked_mha / chunked_mha_bwd, what the ranks of a ring compute
    # together), at the s2a training shape and a ragged one padded to the
    # ring, a key mask with ragged rows and a row without any valid key.
    # Held against the same steps through the plain versions (the limits
    # above) and against one whole-sequence K3 / K4 call (printed beside the
    # same limits); bound and library as the whole attention's.
    for (b, t, h, d), n in itertools.product(RING_SHAPES if part in (None, "attention") else (),
                                             RING_SIZES):
        q, k, v, g = (normal(b, t, h, d).to(bf16) for _ in range(4))
        lens = [t - 37 * i for i in range(b - 1)] + [0]  # the last row: no valid key
        mask = torch.arange(t, device=dev)[None] < torch.tensor(lens, device=dev)[:, None]
        label = f"ring of {n} B{b} T{t} H{h} D{d}, a row without keys"
        key_work = sum(x or t for x in lens) * t * h * d  # the keyless row: every key
        elems = b * t * h * d
        exps = b * t * t * h

        def plain_attend(q, k, v, mask=None, return_lse=True):
            return (ops.mha_reference(q, k, v, mask=mask),
                    ops.attention_lse_reference(q, k, mask=mask))

        def ring_fwd(attend=ops.flash_mha, n=n, mask=mask):
            o, lse = ring_attention.chunked_mha(q, k, v, mask, n, attend=attend)
            return o, lse.reshape(b * h, t)

        blk = -(-t // n)

        def last_chunk_dropped():
            keep = mask.clone()
            keep[:, (n - 1) * blk:] = False
            keep[-1] = False
            return ring_fwd(plain_attend, mask=keep)

        qt, kt, vt = (z.transpose(1, 2).contiguous().requires_grad_() for z in (q, k, v))
        gt = g.transpose(1, 2).contiguous()
        sdpa_mask = mask[:, None, None, :]

        def sdpa_fwd():
            with torch.enable_grad():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask)

        def sdpa_fwd_bwd():
            with torch.enable_grad():
                return torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), gt)

        compare("attention", label, ring_fwd, lambda: ring_fwd(plain_attend),
                {"last key chunk dropped": last_chunk_dropped},
                (4 * key_work, 4 * elems * 2 + b * t + b * h * t * 4, exps),
                ("scaled_dot_product_attention, inputs requiring grad", sdpa_fwd))
        o, lse = ring_attention.chunked_mha(q, k, v, mask, n)
        whole_o, whole_lse = ops.flash_mha(q, k, v, mask=mask, return_lse=True)
        err_o = (o.float() - whole_o.float()).abs().max().item()
        err_lse = (lse.reshape(b * h, t) - whole_lse).abs().max().item()
        tol_o = MAX_ABS_TOL * whole_o.float().abs().max().item()
        print(f"kernel attention {label}: against one whole-sequence K3 call max abs err "
              f"{err_o:.4g} (tol {tol_o:.4g}), LSE {err_lse:.4g} (tol {LSE_ABS_TOL})", flush=True)
        if not (err_o <= tol_o and err_lse <= LSE_ABS_TOL):
            fail(f"{label}: the merged ring differs from whole-sequence K3")

        def ring_bwd(grads=ops.flash_mha_bwd, o=o, g=g):
            return ring_attention.chunked_mha_bwd(q, k, v, mask, o, lse, g, n, grads=grads)

        def last_chunk_grads_dropped():
            dq, dk, dv = ring_bwd(ops.flash_mha_bwd_reference)
            dk, dv = dk.clone(), dv.clone()
            dk[:, (n - 1) * blk:] = 0
            dv[:, (n - 1) * blk:] = 0
            return dq, dk, dv

        compare("attention_bwd", label, ring_bwd, lambda: ring_bwd(ops.flash_mha_bwd_reference),
                {"delta dropped": lambda: ring_bwd(ops.flash_mha_bwd_reference,
                                                   o=torch.zeros_like(o)),
                 "last key chunk's dk and dv dropped": last_chunk_grads_dropped},
                (10 * key_work, 8 * elems * 2 + b * h * t * 4 + b * t, exps),
                ("scaled_dot_product_attention backward", sdpa_fwd_bwd, sdpa_fwd))
        whole = ops.flash_mha_bwd(q, k, v, mask, whole_o, whole_lse, g)
        errs = [(x.float() - y.float()).abs().max().item() for x, y in zip(ring_bwd(), whole)]
        tols = [MAX_ABS_TOL * y.float().abs().max().item() for y in whole]
        print(f"kernel attention_bwd {label}: against one whole-sequence K4 call max abs err "
              f"dq/dk/dv {[round(e, 6) for e in errs]} (tol {[round(x, 6) for x in tols]})",
              flush=True)
        if not all(e <= x for e, x in zip(errs, tols)):
            fail(f"{label}: the ring's K4 steps differ from whole-sequence K4")

    # K6: each variant at each query tile, at the ablation's shape (B32
    # T1408 H16 D24; not under --attention-kernels) and at two ragged ones.
    # The library call is SDPA (the full softmax) on the (B, H, T, D) layout.
    k6_shapes = [(2, 701, 8, 24), (2, 701, 8, 64)] if part in (None, "attention") else []
    if part is None:
        k6_shapes.insert(0, SHAPE)
    for b, t, h, d in k6_shapes:
        q, k, v = (normal(b, t, h, d).to(bf16) for _ in range(3))
        last = (t - 1) // 64 * 64  # the first key of the last tile
        k_cut, v_cut = k[:, :last].contiguous(), v[:, :last].contiguous()
        qt, kt, vt = (z.transpose(1, 2).contiguous() for z in (q, k, v))

        def noexp_without_max():
            s = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * d ** -0.5
            o = torch.einsum("bhij,bjhd->bihd", s.to(bf16).float(), v.float())
            return (o / (s.sum(-1) + 1e6).transpose(1, 2)[..., None]).to(bf16)

        for variant in VARIANTS:
            faults = {"scale dropped": lambda: attn_variant_reference(
                          q * d ** 0.5, k, v, variant=variant),
                      "last key tile skipped": lambda: attn_variant_reference(
                          q, k_cut, v_cut, variant=variant)}
            if variant == "noexp":
                # the max left out of both terms (out of the denominator
                # alone it moves the output by ~0.5 %, under the limit)
                faults["row max left out"] = noexp_without_max
            for block_q in BLOCK_Q:
                compare("attn_variants", f"B{b} T{t} H{h} D{d} {variant} block_q {block_q}",
                        lambda: ops.attn_variant(q, k, v, variant=variant, block_q=block_q),
                        lambda: attn_variant_reference(q, k, v, variant=variant), faults,
                        variant_work(variant, b, t, h, d),
                        ("scaled_dot_product_attention",
                         lambda: F.scaled_dot_product_attention(qt, kt, vt)))
    if part == "attention":
        return cases

    # K1: the 12 units of one request's 500-frame decode (profile_resunit.
    # CASES: C 768 at T 4000 ... C 96 at T 160016; the masked decode runs the
    # tail blocks' units as K1 too), the codec encoder's 12 on a 10 s prompt
    # (ENCODER_CASES: C 64 at T 160160 ... C 512 at T 4004) and, not under
    # --codec-kernels, the 12 of one served engine call (SERVED_CASES: bucket
    # 4 on a 512-frame canvas), the 12 of a one-row call on that canvas, the
    # encoder's 12 on path (g)'s other prompts (3 s: C 64 at T 48160 ...) and
    # on its masked batch (B4 on the longest row's canvas, C 64 at T 160160
    # ...), each at the N tile the wrapper picks. No one PyTorch call computes the unit; as information
    # each case also times cuDNN's conv1d of the dilated conv plus the
    # matmul of the k=1 conv (layouts made untimed).
    tokenize_cases = tuple(
        case for s_ in PROMPT_SECONDS for case in encoder_units(encoder_samples(s_), 1)
        if case not in ENCODER_CASES) + encoder_units(
            max(encoder_samples(s_) for s_ in BATCH_PROMPT_SECONDS), len(BATCH_PROMPT_SECONDS))
    # and (j)'s dump: the encoder's 12 units on a batch of 8 windows of 60 s
    dump_cases = encoder_units(encoder_samples(DUMP_WINDOW_SECONDS, 16000), DUMP_BATCH)
    # and (k)'s exported codec: its 12 encoder and 12 decoder units on one
    # clip of CODEC_CLIP_SECONDS (the round trip and the gradient check)
    clip_frames = int(CODEC_CLIP_SECONDS * 50)
    codec_clip_cases = encoder_units(clip_frames * 320, 1) + decoder_units(clip_frames, 1)
    k1_cases = RESUNIT_CASES + ENCODER_CASES + (
        SERVED_RESUNIT_CASES + ONE_ROW_RESUNIT_CASES + tokenize_cases + dump_cases
        + codec_clip_cases if part is None else ())
    for label, b, t, c, d in k1_cases if part in (None, "codec") else ():
        x = normal(b, t, c).to(bf16)
        p = resunit_params(c)
        compare("resunit", f"{label} tile {ops.resunit.resunit_tile(b, t, c, sms)}",
                lambda: ops.fused_residual_unit(x, *p, d),
                lambda: ops.resunit_reference(x, *p, dilation=d),
                {"b1 dropped": lambda: ops.resunit_reference(
                    x, *replaced(p, 5, p[5] * 0), dilation=d),
                 "alpha1 = 1": lambda: ops.resunit_reference(
                    x, *replaced(p, 0, p[0] * 0 + 1), dilation=d)},
                resunit_work(b, t, c))
        xt, w7t = x.transpose(1, 2).contiguous(), p[1].permute(2, 1, 0).contiguous()
        conv_ms = median_ms(lambda: F.conv1d(xt, w7t, p[2].to(bf16), padding=3 * d, dilation=d))
        mm_ms = median_ms(lambda: torch.matmul(x, p[4][0]))
        k1 = cases["resunit"][-1]
        k1.update(b=b, t=t, c=c, dilation=d, conv1d_ms=conv_ms, matmul_ms=mm_ms)
        print(f"kernel resunit {label}: F.conv1d (cuDNN) {conv_ms:.4f} + matmul {mm_ms:.4f} = "
              f"{conv_ms + mm_ms:.4f} ms, as information (not library_ms: neither does the "
              f"snakes, biases or residual); K1 / them {k1['ms'] / (conv_ms + mm_ms):.3f}",
              flush=True)
        del x, xt
    # K2: the s=4 and s=2 tail blocks of one request's decode (profile_
    # decoder_block.CASES), also under --codec-kernels. As information each
    # case also times K2's front alone (snake pass and phase product) at its
    # column tile against the front's bound, the parent checkout's front
    # (--parent) and cuDNN's conv_transpose1d on the snake'd input
    # (channels first, layout changes untimed).
    # and (k)'s two K2 blocks on the clip's 100 frames (not under --codec-kernels)
    k2_cases = DECODER_BLOCK_CASES + (decoder_blocks(clip_frames, 1) if part is None else ())
    for label, b, t, cin, cout, s in k2_cases if part in (None, "codec") else ():
        x = normal(b, t, cin).to(bf16)
        a0 = alpha(cin)
        lim = (2 * s * cout) ** -0.5
        wt = uniform(2 * s, cin, cout, lo=-lim, hi=lim).to(bf16)
        w3 = phase_weights(wt, s).contiguous()
        bias3 = normal(cout, scale=0.5).repeat(s)
        rus = [resunit_params(cout) for _ in range(3)]
        # the transposed conv takes 2 taps per output sample; the units' work
        # is 3 K1s at the output rate; x read once, the output written once
        front_flops, front_bytes = front_work(b, t, cin, cout, s)
        units_flops, _ = resunit_work(b, t * s, cout)
        weight_bytes = 2 * 2 * cin * s * cout + 3 * 8 * cout * cout * 2
        compare("decoder_block", label,
                lambda: ops.fused_decoder_block(x, a0, w3, bias3, rus, s),
                lambda: ops.decoder_block_reference(x, a0, w3, bias3, rus, stride=s),
                {"bias dropped": lambda: ops.decoder_block_reference(
                    x, a0, w3, bias3 * 0, rus, stride=s),
                 "alpha0 = 1": lambda: ops.decoder_block_reference(
                    x, a0 * 0 + 1, w3, bias3, rus, stride=s)},
                (front_flops + 3 * units_flops,
                 2 * b * t * cin + 2 * b * t * s * cout + weight_bytes))
        front_tile = ops.decoder_block.decoder_block_tile(b, t, cin, s * cout, s, sms)
        front_ms = median_ms(lambda: ops.decoder_block.tconv_phase(x, a0, w3, bias3, s))
        front_bound, front_by = bound(front_flops, front_bytes)
        parent_ms = None
        if parent_front is not None:
            parent_ms = median_ms(lambda: parent_front(x, a0, w3, bias3, s))
        sx = ops.snake(x, a0).transpose(1, 2).contiguous()
        wct, bt = wt.permute(1, 2, 0).contiguous(), bias3[:cout].to(bf16)
        tconv_ms = median_ms(lambda: F.conv_transpose1d(sx, wct, bt, stride=s, padding=s // 2))
        cases["decoder_block"][-1].update(tile=front_tile, front_ms=front_ms,
                                          front_bound_ms=front_bound,
                                          parent_front_ms=parent_ms, conv_transpose1d_ms=tconv_ms)
        print(f"kernel decoder_block {label}: front (snake pass + phase product) at tile "
              f"{front_tile} {front_ms:.4f} ms, bound {front_bound:.4f} ({front_by}), front / bound "
              f"{front_ms / front_bound:.2f}; parent front "
              f"{'n/a (no --parent)' if parent_ms is None else f'{parent_ms:.4f} ms'}; "
              f"F.conv_transpose1d (cuDNN) {tconv_ms:.4f} ms as information (not library_ms: "
              f"no snake, no units); front / it {front_ms / tconv_ms:.3f}", flush=True)
        del x, sx
    if part == "codec":
        return cases
    # K3: t2s (masked canvas), the length predictor, s2a without and with a
    # key mask. The t2s and s2a masks also cover the first 70 keys, so every
    # row's first KV tile is fully masked. The library call is SDPA on the
    # (B, H, T, D) layout with the same boolean mask (layouts made untimed).
    k3_cases = (("t2s T604 H8 D24 mask", (604, 8, 24, 70, 553)),
                ("length predictor T101 H8 D24 mask", (101, 8, 24, 0, 90)),
                ("s2a T650 H16 D64", (650, 16, 64, None, None)),
                ("s2a T650 H16 D64 mask", (650, 16, 64, 70, 599)))
    for label, (t, h, d, lo, hi) in k3_cases if part is None else ():
        q, k, v = (normal(1, t, h, d).to(bf16) for _ in range(3))
        pos = torch.arange(t, device=dev)[None]
        mask = None if lo is None else (pos >= lo) & (pos < hi)
        valid = torch.ones_like(pos, dtype=torch.bool) if mask is None else mask
        faults = {}
        tail = valid & (pos < t // 64 * 64)  # the keys of the last, partial tile dropped
        if not torch.equal(tail, valid):
            faults["tail tile dropped"] = lambda: ops.mha_reference(q, k, v, mask=tail)
        if mask is not None:
            faults["mask ignored"] = lambda: ops.mha_reference(q, k, v)
        if d % 32:  # scaled by the depth the kernel pads D to, not by D
            faults["scaled by padded D"] = lambda: ops.mha_reference(
                q * (d / (-(-d // 32) * 32)) ** 0.5, k, v, mask=mask)
        qt, kt, vt = (z.transpose(1, 2).contiguous() for z in (q, k, v))
        sdpa_mask = None if mask is None else mask[:, None, None, :]
        n_keys = int(valid.sum())
        compare("attention", f"{label}, {tile(1, h, t)}", lambda: ops.flash_mha(q, k, v, mask=mask),
                lambda: ops.mha_reference(q, k, v, mask=mask), faults,
                (4 * h * t * n_keys * d, 4 * t * h * d * 2 + t, h * t * n_keys),
                ("scaled_dot_product_attention", lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=sdpa_mask)))
    # K3 at HuBERT-large's layers (H16 D64): one 10 s prompt's 500 frames
    # unmasked, path (g)'s batch of 4 prompts of 3-10 s on a 500-frame
    # canvas with the key mask, and (j)'s dump batch of 8 windows of 60 s
    # (3000 frames) with a ragged key mask; the library call as above
    hubert_k3 = (("hubert B1 T500 H16 D64", 1, 500, None),
                 ("hubert B4 T500 H16 D64 mask", 4, 500, (150, 275, 400, 500)),
                 ("hubert dump B8 T3000 H16 D64 mask", DUMP_BATCH, 3000,
                  (3000, 3000, 2750, 2999, 1800, 3000, 1234, 2500)))
    for label, b, t, lens in hubert_k3 if part is None else ():
        h, d = 16, 64
        q, k, v = (normal(b, t, h, d).to(bf16) for _ in range(3))
        pos = torch.arange(t, device=dev)[None]
        mask = None if lens is None else pos < torch.tensor(lens, device=dev)[:, None]
        valid = pos.expand(b, t) >= 0 if mask is None else mask
        tail = valid & (pos < t // 64 * 64)  # the keys of the last, partial tile dropped
        faults = {"tail tile dropped": lambda: ops.mha_reference(q, k, v, mask=tail)}
        if mask is not None:
            faults["mask ignored"] = lambda: ops.mha_reference(q, k, v)
        qt, kt, vt = (z.transpose(1, 2).contiguous() for z in (q, k, v))
        sdpa_mask = None if mask is None else mask[:, None, None, :]
        n_keys = int(valid.sum())  # summed over the batch rows
        compare("attention", f"{label}, {tile(b, h, t)}",
                lambda: ops.flash_mha(q, k, v, mask=mask),
                lambda: ops.mha_reference(q, k, v, mask=mask), faults,
                (4 * h * t * n_keys * d, 4 * b * t * h * d * 2 + b * t, h * t * n_keys),
                ("scaled_dot_product_attention", lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=sdpa_mask)))
    # K5: every int8 linear of one request (profile_qdense.CASES: s2a at
    # M = 150 + 512, t2s at M = 128 + 4 + 1250, the length predictor at
    # M = 1 + 128, a batch of 4 s2a rows) and of one served engine call in
    # bucket 4 (SERVED_CASES), each at the tile the wrapper picks. The
    # library call is _weight_int8pack_mm where this PyTorch has it on CUDA
    # (not timed under --int8-kernels: up to ~50 ms a call); beside it the
    # bf16 matmul on the dequantized weight, the cuBLAS yardstick.
    int8_pack_mm = None if part is None else False
    for label, m, kdim, n in INT8_CASES + SERVED_INT8_CASES:
        x = normal(m, kdim).to(bf16)
        q8, scale = ops.quantize_weight(normal(kdim, n) * uniform(n, lo=0.5, hi=2.0))
        tail_start = m // 64 * 64 if m % 64 else m - 64
        qt8, scale16 = q8.t().contiguous(), scale.to(bf16)
        if int8_pack_mm is None:  # a CUDA int8 weight-only product in this PyTorch?
            try:
                torch._weight_int8pack_mm(x, qt8, scale16)
                int8_pack_mm = True
            except (RuntimeError, NotImplementedError, AttributeError) as e:
                print(f"kernel int8_dense: torch._weight_int8pack_mm is not available on "
                      f"CUDA here ({type(e).__name__}); its library_ms is torch.matmul "
                      f"on the bf16-dequantized weight, the dequant untimed", flush=True)
                int8_pack_mm = False
        w_deq = (q8.float() * scale).to(bf16)
        if int8_pack_mm:
            library = ("_weight_int8pack_mm", lambda: torch._weight_int8pack_mm(x, qt8, scale16))
        else:
            library = ("matmul bf16-dequantized", lambda: torch.matmul(x, w_deq))

        def tail_zeroed():
            out = ops.int8_dense_reference(x, q8, scale)
            out[tail_start:] = 0
            return out

        bn, bm, splits = ops.qdense.int8_dense_tile(m, kdim, n, sms)
        compare("int8_dense", f"{label} M{m} K{kdim} N{n} tile {bn}x{bm}/{splits}",
                lambda: ops.int8_dense(x, q8, scale),
                lambda: ops.int8_dense_reference(x, q8, scale),
                {"scale ignored": lambda: (x.float() @ q8.float()).to(bf16),
                 "scale by row": lambda: ((x.float() @ q8.float())
                                          * scale[torch.arange(m, device=dev) % n][:, None]).to(bf16),
                 "last K step dropped": lambda: ops.int8_dense_reference(
                     x[:, :-32], q8[:-32], scale),
                 "tail M rows zeroed": tail_zeroed},
                int8_work(m, kdim, n), library)
        # the yardstick: the bf16 product on the dequantized weight
        matmul_ms = median_ms(lambda: torch.matmul(x, w_deq))
        cases["int8_dense"][-1].update(m=m, k=kdim, n=n, tile=f"{bn}x{bm}/{splits}",
                                       matmul_bf16_ms=matmul_ms)
        print(f"kernel int8_dense {label} M{m} K{kdim} N{n}: bf16 matmul on the dequantized "
              f"weight ms {matmul_ms:.4f}, K5 / matmul {cases['int8_dense'][-1]['ms'] / matmul_ms:.3f}",
              flush=True)
    return cases


def decode_plain(torch, ops, codec, codes):
    """The codec decode of ``codes`` through the kernels' plain versions."""
    x = codec.quantizer.from_codes(codes).to(codec.dtype)
    stem, *blocks, snake, final = codec.decoder.model
    x = stem(x)
    for block in blocks:
        snake0, tconv, *units = block.block
        x = tconv(snake0(x))
        for u in units:
            x = ops.resunit_reference(x, *u.folded(), dilation=u.dilation)
    return torch.tanh(final(snake(x)))


def check_wav(engine, label, status, sr, pcm, want_samples=None) -> float:
    """A served WAV: HTTP 200, the engine's rate, int16, ``want_samples``
    samples (else a whole number of frames), not silent; returns its rms."""
    import numpy as np

    hop = engine.hop_length
    rms = float(np.sqrt(np.mean(pcm.astype(np.float64) ** 2))) if pcm.size else 0.0
    if status != 200 or sr != engine.sample_rate or pcm.dtype != np.int16:
        fail(f"{label}: HTTP {status}, {sr} Hz, {pcm.dtype}")
    if want_samples is not None and pcm.shape != (want_samples,):
        fail(f"{label}: {pcm.shape} samples, want ({want_samples},)")
    if want_samples is None and (pcm.size == 0 or pcm.size % hop):
        fail(f"{label}: {pcm.size} samples is not a whole number of {hop}-sample frames")
    if not rms > 0:
        fail(f"{label}: silent WAV")
    return rms


def post_json(base: str, path: str, body: dict, timeout: float = 600):
    """(status, response bytes, seconds) of a JSON POST; an HTTP error's
    status and body are returned, not raised."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"{base}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, data = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, data = e.code, e.read()
    return status, data, time.perf_counter() - t0


def block_int8_sites(cfg) -> int:
    """How many of a Conformer block's nine linears pass the K5 shape gate."""
    from edm_tts_tpu_torch.ops import quantizable_shape

    d, inner, ff = cfg.dim, cfg.heads * cfg.dim_head, cfg.dim * cfg.ff_mult
    conv = cfg.dim * cfg.conv_expansion_factor
    shapes = [(d, ff), (ff, d), (d, inner), (d, 2 * inner), (inner, d), (d, 2 * conv),
              (conv, d), (d, ff), (ff, d)]
    return sum(quantizable_shape(k, n) for k, n in shapes)


def int8_request_launches(t2s_cfg, s2a_cfg, has_gt: bool, pred_iters: int, steps: int) -> dict:
    """One bf16 request's launches with int8 t2s and s2a weights and the
    codec's masked decode: K3 on every attention, K5 on every linear that
    passes its shape gate, K1 on the decoder's units (the length predictor
    runs unless the length is given)."""
    from edm_tts_tpu_torch.ops import quantizable_shape

    main, lp = t2s_cfg.main_encoder_config, t2s_cfg.length_predictor_config
    enc, h = s2a_cfg.encoder_config, t2s_cfg.hidden_size
    s2a_passes = (s2a_cfg.injection_layers[0] + 1) * steps + s2a_cfg.encoder_num_layers
    fine = quantizable_shape(s2a_cfg.hidden_size, s2a_cfg.hidden_size * (
        s2a_cfg.num_quantizers - len(s2a_cfg.injection_layers)))
    int8 = (pred_iters * (main.depth * block_int8_sites(main)
                          + quantizable_shape(h, h)
                          + quantizable_shape(h, t2s_cfg.semantic_vocab_size))
            + (0 if has_gt else lp.depth * block_int8_sites(lp))
            + s2a_passes * block_int8_sites(enc) + fine)
    attention = (main.depth * pred_iters + (0 if has_gt else lp.depth) + s2a_passes)
    return no_launches(resunit=3 * len(s2a_cfg.codec.decoder_rates), attention=attention,
                       int8_dense=int8)


def served_path(torch, t2s, s2a, semantic, dev, smi: str, held: set, held_k1: set):
    """(c): the int8 models behind TTSEngine -> DynamicBatcher -> TTSServer.
    ``held``: the (M, K, N) at which the kernel phase held K5 against its
    plain version, ``held_k1`` the (B, T, C, dilation) of K1; every shape
    the concurrent requests launch K5 or K1 at must be one of them.
    ``semantic``: the engine's semantic tokenizer (path (g) registers
    speakers through it). Returns (the concurrent requests' launches, the
    engine)."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from scipy.io import wavfile

    from edm_tts_tpu_torch.kernels import (
        all_launches,
        int8_dense_shapes,
        reset_launches,
        resunit_shapes,
    )
    from edm_tts_tpu_torch.profile_synthesis import (
        PRED_ITERS,
        PROMPT_FRAMES,
        SERVED_TEXTS,
        STEPS,
        served_engine,
    )
    from edm_tts_tpu_torch.serving import TTSServer
    from edm_tts_tpu_torch.serving.chunking import split_text

    t2s_cfg, s2a_cfg = t2s.cfg, s2a.cfg
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)

    # the bf16 s2a's level-0 logits on a 662-frame canvas, before the engine
    # quantizes the models in place
    tokens = torch.randint(0, s2a_cfg.num_semantic_tokens, (1, PROMPT_FRAMES + 512),
                           generator=gen, device=dev)
    canvas = s2a.embed_semantic(tokens) + s2a.mask_token
    logits_bf16 = s2a.forward_first_level(canvas)
    engine = served_engine(t2s, s2a, dev, SEED + 30, semantic)
    rel = rel_l2(torch, engine.s2a.forward_first_level(canvas), logits_bf16)
    print(f"served (c) int8 vs bf16 s2a level-0 logits on a {canvas.shape[1]}-frame canvas: "
          f"relative l2 {rel:.4g} (tol {INT8_LOGITS_REL_L2_TOL})", flush=True)
    if not rel <= INT8_LOGITS_REL_L2_TOL:
        fail(f"int8 s2a logits differ from the bf16 ones: relative l2 {rel}")
    engine.synthesize(["A warm-up request before the server starts."], "spk", gt_lengths=[100])

    def expected(has_gt: bool) -> dict:
        return int8_request_launches(t2s_cfg, s2a_cfg, has_gt, PRED_ITERS, STEPS)

    calls = []  # (rows, engine wall s, audio s) of each engine call the server makes
    synthesize = engine.synthesize

    def timed_synthesize(texts, speaker, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wavs = synthesize(texts, speaker, **kw)
        torch.cuda.synchronize()
        calls.append((len(texts), time.perf_counter() - t0,
                      sum(len(w) for w in wavs) / engine.sample_rate))
        return wavs

    engine.synthesize = timed_synthesize
    server = TTSServer(engine, max_batch=16, max_wait_ms=1000.0).start()
    base = f"http://{server.host}:{server.port}"

    def post(body: dict):
        req = urllib.request.Request(f"{base}/synthesize", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            status, data = r.status, r.read()
        sr, pcm = wavfile.read(io.BytesIO(data))
        return status, sr, pcm, time.perf_counter() - t0

    texts = SERVED_TEXTS
    bodies = [{"text": t, "speaker": "spk", "seed": 7} for t in texts]
    bodies[3]["gt_length"] = 500
    counts = {}
    try:
        # four concurrent requests: the three without a length share one
        # engine call, the one with a length gets its own
        reset_launches()
        with ThreadPoolExecutor(4) as pool:
            results = list(pool.map(post, bodies))
        torch.cuda.synchronize()
        counts["concurrent"] = all_launches()
        shapes = dict(int8_dense_shapes)
        k1_shapes = dict(resunit_shapes)
        stats = json.loads(urllib.request.urlopen(f"{base}/stats", timeout=60).read())
        for i, (status, sr, pcm, lat) in enumerate(results):
            want = 500 * engine.hop_length if "gt_length" in bodies[i] else None
            rms = check_wav(engine, f"request {i}", status, sr, pcm, want)
            print(f"served (c) request {i}: {len(texts[i].encode())} text bytes, "
                  f"{pcm.size / sr:.2f} s audio, rms {rms:.1f}, latency {lat:.4f} s "
                  f"(batch window 1.0 s)", flush=True)
        n_calls = stats["engine_calls"]
        if not stats["mean_batch"] > 1 or stats["failed"]:
            fail(f"the batcher did not coalesce the concurrent requests: {stats}")
        want = {k: expected(True)[k] + (n_calls - 1) * expected(False)[k] for k in KERNELS}
        print(f"served (c) concurrent: /stats {stats} launches {counts['concurrent']} "
              f"expected {want}", flush=True)
        if counts["concurrent"] != want:
            fail(f"served launches {counts['concurrent']} != expected {want}")
        for (m, k, n), count in sorted(shapes.items()):
            print(f"served (c) concurrent: K5 at M{m} K{k} N{n}: {count} launches"
                  f"{'' if (m, k, n) in held else ' (not among the kernel cases)'}", flush=True)
        if not held.issuperset(shapes):
            fail(f"served K5 shapes {sorted(set(shapes) - held)} were not held against "
                 f"the plain version")
        for (b, t, c, d), count in sorted(k1_shapes.items()):
            print(f"served (c) concurrent: K1 at B{b} T{t} C{c} dil{d}: {count} launches"
                  f"{'' if (b, t, c, d) in held_k1 else ' (not among the kernel cases)'}",
                  flush=True)
        if not held_k1.issuperset(k1_shapes):
            fail(f"served K1 shapes {sorted(set(k1_shapes) - held_k1)} were not held against "
                 f"the plain version")
        for rows, wall, audio_s in calls:
            print(f"served (c) engine call: {rows} rows, wall {wall:.4f} s for {audio_s:.2f} s "
                  f"of audio: {wall / audio_s:.5f} s per audio s ({smi})", flush=True)

        # one long request of three chunks, through the same batcher
        long_text = (
            "The first chunk of this long request talks about the morning train, which "
            "was late again. The second chunk describes the crowded platform and the "
            "announcements that nobody could hear. The third and last chunk ends the "
            "story with a cup of coffee at the office, finally.")
        n_chunks = len(split_text(long_text, 120))
        reset_launches()
        calls_before = len(calls)
        status, sr, pcm, lat = post({"text": long_text, "speaker": "spk", "seed": 3,
                                     "long": True, "max_chunk_chars": 120})
        torch.cuda.synchronize()
        counts["long"] = all_launches()
        rms = check_wav(engine, "long request", status, sr, pcm)
        n_long = len(calls) - calls_before
        want = {k: n_long * expected(False)[k] for k in KERNELS}
        print(f"served (c) long request: {n_chunks} chunks in {n_long} engine call(s), "
              f"{pcm.size / sr:.2f} s audio, rms {rms:.1f}, latency {lat:.4f} s, "
              f"launches {counts['long']} expected {want}", flush=True)
        if n_chunks != 3 or counts["long"] != want:
            fail(f"long request: {n_chunks} chunks, launches {counts['long']} != {want}")
    finally:
        server.shutdown()
        del engine.synthesize  # the timing wrapper (it holds the engine in a cycle)

    # the masked decode of a padded canvas against exact-size decodes
    codec = engine.s2a.acoustic_model
    codes = torch.randint(0, s2a_cfg.num_codevectors, (2, s2a_cfg.num_quantizers, 512),
                          generator=gen, device=dev)
    valid = torch.tensor([500, 333], device=dev)
    masked = codec.decode_from_codes(codes, valid)
    for i, v in enumerate(valid.tolist()):
        exact = codec.decode_from_codes(codes[i:i + 1, :, :v])
        n = v * engine.hop_length
        rel = rel_l2(torch, masked[i, :n], exact[0, :n])
        print(f"served (c) masked decode row {i} ({v} of 512 frames) vs exact-size decode: "
              f"relative l2 {rel:.4g} (tol {DECODE_REL_L2_TOL})", flush=True)
        if not rel <= DECODE_REL_L2_TOL:
            fail(f"masked decode row {i} differs from the exact-size decode: {rel}")
    return counts["concurrent"], engine


@contextlib.contextmanager
def plain_versions(ops):
    """The codec's residual units and decoder blocks and HuBERT's attention
    through their plain versions for the block (K1, K2 and K3 swapped out
    where the models call them); fails if a kernel launches inside it."""
    import edm_tts_tpu_torch.models.codec.decoder as decoder_mod
    import edm_tts_tpu_torch.models.codec.layers as layers_mod
    import edm_tts_tpu_torch.models.hubert.model as hubert_mod
    from edm_tts_tpu_torch.kernels import all_launches

    saved = layers_mod.fused_residual_unit, decoder_mod.fused_decoder_block, hubert_mod.mha
    layers_mod.fused_residual_unit = (
        lambda x, *p: ops.resunit_reference(x, *p[:-1], dilation=p[-1]))
    decoder_mod.fused_decoder_block = (
        lambda x, a0, w3, b3, ru, s: ops.decoder_block_reference(x, a0, w3, b3, ru, stride=s))
    hubert_mod.mha = lambda q, k, v, *, mask=None, implementation="auto": ops.mha_reference(
        q, k, v, mask=mask)
    before = all_launches()
    try:
        yield
    finally:
        layers_mod.fused_residual_unit, decoder_mod.fused_decoder_block, hubert_mod.mha = saved
    if all_launches() != before:
        fail(f"the plain versions launched kernels: {before} -> {all_launches()}")


def tokenization_path(torch, ops, engine, dev, smi: str, held_k1: set) -> dict:
    """(g): prompt tokenization at full width through ``engine`` (its codec
    and HuBERT-large, bf16) behind a TTSServer; returns the 10 s prompt's
    launches."""
    import base64
    import copy

    import numpy as np
    from scipy.io import wavfile

    from edm_tts_tpu_torch.kernels import all_launches, reset_launches, resunit_shapes
    from edm_tts_tpu_torch.models.tokenizer import AudioTokenizer
    from edm_tts_tpu_torch.ops.resample import resample
    from edm_tts_tpu_torch.profile_tokenization import (
        PROMPT_SECONDS,
        PROMPT_SR,
        device_profile,
        parts_median,
        prompt_wav,
    )
    from edm_tts_tpu_torch.serving import TTSServer

    tok = engine.tokenizer
    codec, sem = tok.codec, tok.semantic
    cfg = codec.config
    # the oracle: the same weights in f32, run through the plain versions
    codec32 = copy.deepcopy(codec).float()
    codec32.pack()
    tok32 = AudioTokenizer(codec32, copy.deepcopy(sem).float())

    def same(a, b) -> float:
        return (a == b).float().mean().item()

    def held(label: str, shapes) -> None:
        """Fail unless every K1 shape of this run was held in phase 3."""
        for (b, t, c, d), n in sorted(shapes.items()):
            print(f"tokenize (g) {label}: K1 at B{b} T{t} C{c} dil{d}: {n} launches"
                  f"{'' if (b, t, c, d) in held_k1 else ' (not among the kernel cases)'}",
                  flush=True)
        if not held_k1.issuperset(shapes):
            fail(f"(g) {label}: K1 shapes {sorted(set(shapes) - held_k1)} were not held "
                 f"against the plain version")

    def against_plain(label: str, k: dict, p: dict, valid=None) -> None:
        """Fail unless the kernels' run ``k`` of ``tok.run_steps`` is within
        the limits of the plain versions' run ``p`` on the same inputs. With
        ``valid`` (a batch) over each row's first ``valid[i]`` frames (the
        padding of a canvas is one repeated frame, whose near tie would
        count hundreds of times), and the level-0 codes' share is printed,
        not held: at the prompts' flip rate against the plain versions (4-5 %
        on an H100) its spread over the batch's 1325 frames spans the 0.95
        limit. The batch's codes are held against each row's exact-size
        call instead, whose codes are held here."""
        def cut(x):
            return x if valid is None else torch.cat([x[i, :n].flatten() for i, n in enumerate(valid)])

        rel_z = rel_l2(torch, cut(k["latents"]), cut(p["latents"]))
        rel_h = rel_l2(torch, cut(k["states"]), cut(p["states"]))
        same_sem = same(cut(k["semantic_codes"]), cut(p["semantic_codes"]))
        same_ac = same(cut(k["acoustic_codes"][:, 0]), cut(p["acoustic_codes"][:, 0]))
        print(f"tokenize (g) {label}: kernels vs plain versions (bf16): encoder latents "
              f"relative l2 {rel_z:.4g}, layer-{sem.output_layer} states {rel_h:.4g} (tol "
              f"{TOKENIZE_REL_L2_TOL}); identical semantic ids {same_sem:.4f} (min "
              f"{TOKENIZE_SEMANTIC_SAME}), level-0 codes {same_ac:.4f} "
              f"({'not held' if valid else f'min {TOKENIZE_ACOUSTIC_SAME}'})", flush=True)
        if not (rel_z <= TOKENIZE_REL_L2_TOL and rel_h <= TOKENIZE_REL_L2_TOL
                and same_sem >= TOKENIZE_SEMANTIC_SAME
                and (valid is not None or same_ac >= TOKENIZE_ACOUSTIC_SAME)):
            fail(f"(g) {label}: the kernel path is off the plain versions: latents {rel_z}, "
                 f"states {rel_h}, ids {same_sem}, level-0 codes {same_ac}")

    server = TTSServer(engine, max_batch=4, max_wait_ms=50.0).start()
    base = f"http://{server.host}:{server.port}"
    counts, flips = {}, {}
    try:
        for seconds in PROMPT_SECONDS:
            name = f"prompt{seconds:.0f}s"
            wav = prompt_wav(seconds, SEED + 60 + int(seconds))
            body = {"name": name, "sample_rate": PROMPT_SR,
                    "pcm_b64": base64.b64encode(wav.astype("<f4").tobytes()).decode()}
            torch.cuda.synchronize()
            reset_launches()
            status, data, lat = post_json(base, "/speakers", body)
            torch.cuda.synchronize()
            counts[name], shapes = all_launches(), dict(resunit_shapes)
            if status != 200 or json.loads(data) != {"ok": True}:
                fail(f"(g) POST /speakers {name}: HTTP {status} {data[:200]!r}")
            prompt = engine.prompt(name)
            ac, sc = prompt.acoustic_codes, prompt.semantic_codes
            # the request's own steps again, as register_speaker takes them
            x = resample(torch.from_numpy(wav).to(dev), PROMPT_SR, tok.sample_rate).cpu().numpy()
            padded, normalized, _ = tok.prepare(x[None])
            n_code = int(tok.get_code_lengths(padded.shape[-1]))
            n_hubert = int(sem.config.feature_lengths(padded.shape[-1]))
            want = no_launches(resunit=3 * len(cfg.encoder_rates),
                               attention=sem.output_layer)
            print(f"tokenize (g) {name}: POST /speakers HTTP {status} in {lat:.4f} s; codes "
                  f"acoustic {tuple(ac.shape)} semantic {tuple(sc.shape)}, frames codec "
                  f"{ac.shape[-1]} HuBERT {n_hubert} get_code_lengths {n_code}; launches "
                  f"{counts[name]} expected {want}", flush=True)
            if not (ac.shape == (1, cfg.n_codebooks, n_code) and sc.shape == (1, n_code)
                    and n_hubert == n_code):
                fail(f"(g) {name}: frames codec {tuple(ac.shape)}, HuBERT {n_hubert}, "
                     f"semantic {tuple(sc.shape)}, get_code_lengths {n_code}")
            if not (0 <= int(ac.min()) and int(ac.max()) < cfg.codebook_size
                    and 0 <= int(sc.min()) and int(sc.max()) < sem.cluster_centers.shape[0]):
                fail(f"(g) {name}: codes out of range")
            if counts[name] != want:
                fail(f"(g) {name}: launches {counts[name]} != expected {want}")
            held(name, shapes)

            # the kernels against the plain versions (bf16), and bf16 against
            # f32, from the served request's own inputs
            k = tok.run_steps(normalized, padded)
            served_equal = (torch.equal(sc, k["semantic_codes"])
                            and torch.equal(ac, k["acoustic_codes"]))
            print(f"tokenize (g) {name}: the served codes equal those of tok.run_steps on the "
                  f"request's resampled, padded and normalized audio: {served_equal}", flush=True)
            if not served_equal:
                fail(f"(g) {name}: the served codes differ from the compared run's")
            with plain_versions(ops):
                p = tok.run_steps(normalized, padded)
                f32 = tok32.run_steps(normalized, padded)
            against_plain(name, k, p)
            z_k, h_k, z_32, h_32 = k["latents"], k["states"], f32["latents"], f32["states"]
            codes_32, ids_32 = f32["acoustic_codes"], f32["semantic_codes"]
            flips[name] = dict(semantic=1 - same(sc, ids_32), acoustic_l0=1 - same(ac[:, 0], codes_32[:, 0]),
                               acoustic_all=1 - same(ac, codes_32),
                               rel_l2_latents=rel_l2(torch, z_k, z_32),
                               rel_l2_hidden=rel_l2(torch, h_k, h_32))
            print(f"tokenize (g) {name}: bf16 (kernels) vs f32 (plain versions) flip shares: "
                  f"semantic ids {flips[name]['semantic']:.4f}, level-0 codes "
                  f"{flips[name]['acoustic_l0']:.4f}, all {cfg.n_codebooks} levels "
                  f"{flips[name]['acoustic_all']:.4f}; "
                  f"relative l2 latents {flips[name]['rel_l2_latents']:.4g}, states "
                  f"{flips[name]['rel_l2_hidden']:.4g} ({smi})", flush=True)
            del k, p, f32, z_k, h_k, z_32, h_32

            # where the time goes: per part, and the whole tokenization
            for part, (wall, dev_ms) in parts_median(tok, wav, PROMPT_SR).items():
                print(f"tokenize (g) {name} part {part}: wall {wall:.3f} ms, CUDA events "
                      f"{dev_ms:.3f} ms", flush=True)
            prof = device_profile(lambda: engine.register_speaker(f"{name}-p", wav, PROMPT_SR))
            print(f"tokenize (g) {name}: register_speaker wall {prof['wall_s']:.4f} s "
                  f"({prof['wall_s'] / seconds:.5f} s per prompt s), device kernel time "
                  f"{prof['device_ms']:.3f} ms ({prof['device_ms'] / 1e3 / seconds:.5f} s per "
                  f"prompt s) in {prof['kernels']} kernels, busy share {prof['busy']:.3f}; port "
                  f"kernels {prof['port_kernels']} ({smi})", flush=True)

        # one synthesis with the registered 10 s speaker
        name = f"prompt{max(PROMPT_SECONDS):.0f}s"
        status, data, lat = post_json(base, "/synthesize", {"text": "A registered voice.",
                                                           "speaker": name, "seed": 5,
                                                           "gt_length": 150})
        sr, pcm = wavfile.read(io.BytesIO(data)) if status == 200 else (0, np.zeros(0, np.int16))
        rms = check_wav(engine, f"(g) /synthesize with {name}", status, sr, pcm,
                        150 * engine.hop_length)
        print(f"tokenize (g) /synthesize with {name}: {pcm.size / sr:.2f} s audio, rms "
              f"{rms:.1f}, latency {lat:.4f} s", flush=True)
    finally:
        server.shutdown()

    # the batched path: 4 prompts of 3-10 s on one padded canvas with
    # HuBERT's attention mask, through the kernels against the plain
    # versions on the same inputs, and each row's ids and codes against its
    # exact-size call
    prepared = [tok.prepare(resample(torch.from_numpy(prompt_wav(s_, SEED + 70 + i)).to(dev),
                                     PROMPT_SR, tok.sample_rate).cpu().numpy()[None])
                for i, s_ in enumerate(BATCH_PROMPT_SECONDS)]
    lengths = [p_[0].shape[-1] for p_ in prepared]
    t = max(lengths)
    padded = np.concatenate([np.pad(p_[0], ((0, 0), (0, t - n))) for p_, n in zip(prepared, lengths)])
    normalized = np.concatenate([np.pad(p_[1], ((0, 0), (0, t - n)))
                                 for p_, n in zip(prepared, lengths)])
    mask = (np.arange(t)[None] < np.array(lengths)[:, None]).astype(np.int32)
    reset_launches()
    out = tok.compute_codes_batch(normalized, padded, mask)
    torch.cuda.synchronize()
    batch_counts, batch_shapes = all_launches(), dict(resunit_shapes)
    want = no_launches(resunit=3 * len(cfg.encoder_rates), attention=sem.output_layer)
    label = f"batch of {len(lengths)}"
    print(f"tokenize (g) {label} prompts of {list(BATCH_PROMPT_SECONDS)} s on {t} samples with "
          f"the mask: codes {tuple(out['acoustic_codes'].shape)} "
          f"{tuple(out['semantic_codes'].shape)}; launches {batch_counts} expected {want}",
          flush=True)
    if batch_counts != want:
        fail(f"(g) batch: launches {batch_counts} != expected {want}")
    held(label, batch_shapes)
    k = tok.run_steps(normalized, padded, mask)
    with plain_versions(ops):
        p = tok.run_steps(normalized, padded, mask)
    if not (torch.equal(k["semantic_codes"], out["semantic_codes"])
            and torch.equal(k["acoustic_codes"], out["acoustic_codes"])):
        fail("(g) batch: compute_codes_batch and run_steps differ on the same inputs")
    valid = [int(n) for n in tok.get_code_lengths(np.array(lengths))]
    against_plain(f"{label} (each row's {valid} frames)", k, p, valid)
    del k, p
    sem_shares, ac_shares = [], []
    for i, ((pad_i, norm_i, _), n) in enumerate(zip(prepared, valid)):
        alone = tok.compute_codes_batch(norm_i, pad_i)
        sem_shares.append(same(out["semantic_codes"][i, :n], alone["semantic_codes"][0]))
        ac_shares.append(same(out["acoustic_codes"][i, :, :n - 1],
                              alone["acoustic_codes"][0, :, :n - 1]))
    print(f"tokenize (g) {label}: each row against its exact-size call: identical semantic ids "
          f"{[round(x, 4) for x in sem_shares]} (min {BATCH_SEMANTIC_SAME}), identical codes of "
          f"all {cfg.n_codebooks} levels over all frames but the last "
          f"{[round(x, 4) for x in ac_shares]} (min {BATCH_ACOUSTIC_SAME})", flush=True)
    if not (min(sem_shares) >= BATCH_SEMANTIC_SAME and min(ac_shares) >= BATCH_ACOUSTIC_SAME):
        fail(f"(g) batch: row shares semantic {sem_shares}, acoustic {ac_shares}")
    print(f"tokenize (g) flip shares bf16 vs f32: {json.dumps(flips)}", flush=True)
    return counts[f"prompt{max(PROMPT_SECONDS):.0f}s"]


def write_s2a_shards(path: str) -> None:
    """TRAIN_ITEMS seeded items of 800-1000 frames, 12 x 1024 codes."""
    import numpy as np

    from edm_tts_tpu_torch.data.token_shards import TokenShardWriter

    rng = np.random.default_rng(SEED)
    writer = TokenShardWriter(path, items_per_shard=16)
    for i in range(TRAIN_ITEMS):
        t = int(rng.integers(800, 1001))
        writer.add(f"utt{i}", rng.integers(0, 1024, (12, t)), rng.integers(0, 1024, t))
    writer.close()


def write_t2s_shards(path: str) -> None:
    """T2S_TRAIN_ITEMS seeded items, more than length_bucketed's 2048-item
    pool: semantic lengths U[21, 1249], text bytes 20-40 % of them."""
    import numpy as np

    from edm_tts_tpu_torch.data.token_shards import TokenShardWriter

    rng = np.random.default_rng(SEED)
    writer = TokenShardWriter(path, items_per_shard=512)
    for i in range(T2S_TRAIN_ITEMS):
        t = int(rng.integers(21, 1250))
        n_text = max(1, int(t * rng.uniform(0.2, 0.4)))
        writer.add(f"utt{i}", np.zeros((1, t), np.int16), rng.integers(0, 1024, t),
                   text_bytes=rng.integers(0, 256, n_text).tolist())
    writer.close()


def attention_gradient_check(torch, ops, model, loss, label: str,
                             tols=(TRAIN_GRAD_REL_L2_TOL, TRAIN_LOSS_REL_TOL)) -> dict:
    """``loss(model)``'s loss and flattened trainable gradient through K3+K4
    (bf16 or f32, as the model runs) against the same with the Conformer's
    attention replaced by the plain version for one call (and with a planted
    K4 fault: dk scaled by sqrt(D)), within ``tols`` (gradient relative l2,
    loss relative difference); returns the launches of the kernel run."""
    import edm_tts_tpu_torch.models.conformer.conformer as conformer_mod
    import edm_tts_tpu_torch.ops.attention as attention_mod
    from edm_tts_tpu_torch.kernels import all_launches, launches, reset_launches

    def loss_and_grad():
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            value = loss(model)
            value.backward()
        grad = torch.cat([p.grad.flatten() for p in model.parameters() if p.requires_grad])
        model.zero_grad(set_to_none=True)
        return value.item(), grad

    reset_launches()
    loss_k, grad_k = loss_and_grad()
    torch.cuda.synchronize()
    counts = all_launches()
    true_mha = conformer_mod.mha

    def plain_mha(q, k, v, *, mask=None, implementation="auto"):
        return ops.mha_reference(q, k, v, mask=mask)

    conformer_mod.mha = plain_mha
    reset_launches()
    try:
        loss_p, grad_p = loss_and_grad()
    finally:
        conformer_mod.mha = true_mha
    if any(all_launches().values()):
        fail(f"{label}: the plain-attention step launched kernels: {all_launches()}")
    true_bwd = attention_mod.flash_mha_bwd

    def dk_scaled_wrong(q, k, v, mask, o, lse, g):
        dq, dk, dv = true_bwd(q, k, v, mask, o, lse, g)
        return dq, dk * q.shape[-1] ** 0.5, dv

    attention_mod.flash_mha_bwd = dk_scaled_wrong
    try:
        _, grad_fault = loss_and_grad()
    finally:
        attention_mod.flash_mha_bwd = true_bwd
    grad_tol, loss_tol = tols
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel = rel_l2(torch, grad_k, grad_p)
    fault_rel = rel_l2(torch, grad_fault, grad_p)
    del grad_k, grad_p, grad_fault
    print(f"{label}, K3+K4 vs plain attention: loss {loss_k:.8f} vs {loss_p:.8f} (relative "
          f"{loss_rel:.3g}, tol {loss_tol}), gradient relative l2 {grad_rel:.4g} (tol "
          f"{grad_tol}); planted K4 fault (dk scaled by sqrt(D)) {fault_rel:.4g}; "
          f"launches {counts}", flush=True)
    if not (loss_rel <= loss_tol and grad_rel <= grad_tol):
        fail(f"{label}: the gradient through the kernels differs from the plain attention: "
             f"loss {loss_rel}, gradient {grad_rel}")
    if not fault_rel > grad_tol:
        fail(f"{label}: the gradient limit would let a wrong dk pass ({fault_rel})")
    return counts


def no_launches(**counts) -> dict:
    """A launch-count dict of every kernel: 0 unless given."""
    return {name: counts.get(name, 0) for name in KERNELS}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch_line(out: str) -> dict:
    """The ``kernel launches: {...}`` line a CLI prints on the card."""
    from edm_tts_tpu_torch.closed_loop import launch_counts

    counts = launch_counts(out)
    if counts is None:
        fail(f"no 'kernel launches' line in the CLI's output:\n{out[-2000:]}")
    return counts


def check_kernels(label: str, counts: dict, ran: tuple, idle: tuple) -> None:
    """Each kernel of ``ran`` launched, none of ``idle``."""
    print(f"cli (h) {label}: kernel launches {counts}", flush=True)
    if any(not counts.get(k, 0) for k in ran) or any(counts.get(k, 0) for k in idle):
        fail(f"{label}: launches {counts}: want {ran} > 0 and {idle} == 0")


# (h): what each CLI run must and must not launch, by dtype (the bf16 CLIs'
# decode is masked, so K2 is off; at f32 the codec runs the composition)
BF16_KERNELS = ("resunit", "attention")
F32_KERNELS = ("attention_f32",)
NOT_BF16 = ("decoder_block", "attention_bwd", "attn_variants", "attention_f32", "int8_dense_f32",
            "attention_bwd_f32")
NOT_F32 = ("resunit", "decoder_block", "attention", "attention_bwd", "int8_dense",
           "attn_variants", "attention_bwd_f32")
CLI_FRAMES = 200  # the length head is set to predict ~200 frames (4 s)
CLI_LONG_TEXT = ("The first sentence of a long text. A second one follows it closely. "
                 "Then a third, which ends the paragraph. A fourth opens the next one.")


def cli_path(torch, ops, dev, smi: str) -> dict:
    """(h): model directories and the two CLIs. Writes full-width seeded
    random weights (the default codec and s2a, bench.py's t2s with its
    length head set to ~200 frames, HuBERT-large with 1024 centroids; f32)
    as directories in a temporary directory: codec, s2a (acoustic_model_path
    to the codec) and t2s in the reference format (model.safetensors), the
    t2s again as pytorch_model.bin, HuBERT as an HF directory with
    centroids.npy; a 3 s 24 kHz prompt as WAV and FLAC. Then, at once,
    four ``python -m edm_tts_tpu_torch.inference`` runs (bf16 int8
    --text_file of 3 lines from the FLAC and the .bin t2s; f32 int8
    --text_file; bf16 --long in groups of 2; f32 --one_shot) and two
    ``python -m edm_tts_tpu_torch.serve`` (bf16 int8, f32 int8; --speaker
    from the FLAC), and in this process the f32 int8 engine from the same
    directories (TTSEngine.from_dirs): one registered prompt and one
    request, counted (the path's launches), its tokenization against the
    same models with every plain version swapped in. Checks each WAV's
    length (the CLI's sampled frames x 320, or their join), no clipped-to-
    -32768 sample (a NaN's mark) and rms > 0, each process's kernel
    launches, the servers' /synthesize, /speakers, /healthz and /stats, and
    that SIGTERM ends each server with exit code 0. Returns the in-process
    engine's launches."""
    import base64
    import signal
    import tempfile
    import urllib.request

    import numpy as np
    from scipy.io import wavfile

    from edm_tts_tpu_torch.data.audio_io import save_wav
    from edm_tts_tpu_torch.kernels import all_launches, reset_launches
    from edm_tts_tpu_torch.ops.resample import resample
    from edm_tts_tpu_torch.profile_synthesis import PRED_ITERS, STEPS, full_width_models
    from edm_tts_tpu_torch.profile_tokenization import full_width_semantic, prompt_wav
    from edm_tts_tpu_torch.serving import TTSEngine
    from edm_tts_tpu_torch.serving.chunking import join_waveforms
    from edm_tts_tpu_torch.train.export import save_t2s
    from edm_tts_tpu_torch.utils import hub

    root = Path(__file__).resolve().parent
    from edm_tts_tpu_torch.data.flac_encoder import encode_flac

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    procs: list = []
    try:
        t0 = time.perf_counter()
        t2s, s2a = full_width_models(dev, SEED + 70, dtype=torch.float32)
        t2s.length_pred_head.weight.mul_(0.02)
        t2s.length_pred_head.bias.fill_(math.log(CLI_FRAMES))
        semantic = full_width_semantic(dev, SEED + 71, dtype=torch.float32)
        d = {name: str(tmp / name) for name in ("codec", "s2a", "t2s", "t2s_bin", "hubert")}
        hub.save_reference(d["codec"], s2a.acoustic_model)
        hub.save_reference(d["s2a"], s2a, codec_dir=d["codec"])
        hub.save_reference(d["t2s"], t2s)
        save_t2s(d["t2s_bin"], t2s)
        hub.save_hubert_hf(d["hubert"], semantic, centroids="centroids.npy")
        del t2s, s2a, semantic
        gc.collect()
        torch.cuda.empty_cache()
        size = sum(f.stat().st_size for f in tmp.rglob("*") if f.is_file())
        wav24 = prompt_wav(3.0, SEED + 72, 24000)
        save_wav(str(tmp / "prompt.wav"), wav24, 24000)
        (tmp / "prompt.flac").write_bytes(encode_flac(
            np.round(np.clip(wav24, -1, 1) * 32767).astype(np.int64)[None], 24000))
        (tmp / "texts.txt").write_text("A first line to read.\nAnd a second, longer line of "
                                       "text to read aloud.\nThe third.\n")
        print(f"cli (h): model directories written in {time.perf_counter() - t0:.2f} s, "
              f"{size / 2**30:.2f} GiB", flush=True)

        models = ["--codec_model", d["codec"], "--t2s_model", d["t2s"], "--s2a_model", d["s2a"],
                  "--hubert_model", d["hubert"], "--max_speech_len", "600"]
        flac, wav = str(tmp / "prompt.flac"), str(tmp / "prompt.wav")
        texts = str(tmp / "texts.txt")
        runs = {
            "inference bf16 int8 --text_file (.bin t2s, FLAC prompt)": (
                ["--dtype", "bfloat16", "--quantize", "int8", "--text_file", texts, "-s", flac,
                 "--t2s_model", d["t2s_bin"]], BF16_KERNELS + ("int8_dense",), NOT_BF16),
            "inference f32 int8 --text_file": (
                ["--dtype", "float32", "--quantize", "int8", "--text_file", texts, "-s", wav],
                F32_KERNELS + ("int8_dense_f32",), NOT_F32),
            "inference bf16 --long": (
                ["--dtype", "bfloat16", "--long", "-t", CLI_LONG_TEXT, "--long_batch", "2",
                 "--max_chunk_chars", "40", "-s", flac], BF16_KERNELS, NOT_BF16 + ("int8_dense",)),
            "inference f32 --one_shot": (
                ["--dtype", "float32", "--one_shot", "-t", "One shot, at a given length.",
                 "--gt_length", "250", "-s", wav], F32_KERNELS, NOT_F32 + ("int8_dense_f32",)),
        }
        started = {}
        for i, (label, (args, _, _)) in enumerate(runs.items()):
            out = tmp / f"out{i}" / "out.wav"
            out.parent.mkdir()
            cmd = [sys.executable, "-m", "edm_tts_tpu_torch.inference", *models, *args,
                   "-o", str(out)]
            started[label] = (out, subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True))
            procs.append(started[label][1])
        servers = {}
        for dtype in ("bfloat16", "float32"):
            port = free_port()
            cmd = [sys.executable, "-m", "edm_tts_tpu_torch.serve", *models, "--dtype", dtype,
                   "--quantize", "int8", "--speaker", f"alice={flac}", "--host", "127.0.0.1",
                   "--port", str(port)]
            proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            servers[dtype] = (f"http://127.0.0.1:{port}", proc)
            procs.append(proc)

        # the f32 int8 engine in this process: the path's counted launches
        t0 = time.perf_counter()
        engine = TTSEngine.from_dirs(d["codec"], d["t2s"], d["s2a"], d["hubert"], device=dev,
                                     dtype=torch.float32, quantize="int8", max_speech_len=600,
                                     pred_iters=PRED_ITERS, s2a_steps=STEPS)
        print(f"cli (h) f32 engine: TTSEngine.from_dirs in {time.perf_counter() - t0:.2f} s",
              flush=True)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        engine.register_speaker("alice", wav24, 24000)
        torch.cuda.synchronize()
        t_reg = time.perf_counter() - t0
        register_counts = all_launches()
        t0 = time.perf_counter()
        out = engine.synthesize(["An f32 request with a registered voice."], "alice",
                                gt_lengths=[CLI_FRAMES])[0]
        torch.cuda.synchronize()
        t_syn = time.perf_counter() - t0
        counts = all_launches()
        hubert_layers = engine.tokenizer.semantic.output_layer
        print(f"cli (h) f32 engine: register_speaker (3 s at 24 kHz) {t_reg:.3f} s, launches "
              f"{register_counts}; synthesize ({CLI_FRAMES} frames) {t_syn:.3f} s; {smi}",
              flush=True)
        if register_counts != no_launches(attention_f32=hubert_layers):
            fail(f"f32 registration: launches {register_counts}, want {hubert_layers} of "
                 "attention_f32 and nothing else")
        check_kernels("f32 engine (registration + request)", counts,
                      F32_KERNELS + ("int8_dense_f32",), NOT_F32)
        if out.shape != (CLI_FRAMES * engine.hop_length,) or not np.isfinite(out).all() \
                or not float(np.sqrt(np.mean(out ** 2))) > 0:
            fail(f"f32 engine request: {out.shape} samples, finite {np.isfinite(out).all()}")

        # its tokenization against the plain versions on the request's own inputs
        tok = engine.tokenizer
        wav16 = resample(torch.from_numpy(wav24).to(dev), 24000, tok.sample_rate).cpu().numpy()
        padded, normalized, _ = tok.prepare(wav16[None])
        kernel = tok.run_steps(normalized, padded)
        with plain_versions(ops):
            plain = tok.run_steps(normalized, padded)
        served = engine.prompt("alice")
        if not (torch.equal(served.acoustic_codes, kernel["acoustic_codes"])
                and torch.equal(served.semantic_codes, kernel["semantic_codes"])):
            fail("f32 registration: the served codes differ from run_steps' on its inputs")
        ids = (kernel["semantic_codes"] == plain["semantic_codes"]).float().mean().item()
        lvl0 = (kernel["acoustic_codes"][:, 0] == plain["acoustic_codes"][:, 0]).float().mean().item()
        rel_states = rel_l2(torch, kernel["states"], plain["states"])
        rel_latents = rel_l2(torch, kernel["latents"], plain["latents"])
        print(f"cli (h) f32 tokenization vs plain versions: latents rel l2 {rel_latents:.4g}, "
              f"states rel l2 {rel_states:.4g} (tol {F32_TOKENIZE_REL_L2_TOL}), same ids "
              f"{ids:.4f}, same level-0 codes {lvl0:.4f} (limit {F32_TOKENIZE_SAME}) over "
              f"{kernel['semantic_codes'].shape[-1]} frames", flush=True)
        if not (rel_states <= F32_TOKENIZE_REL_L2_TOL and rel_latents <= F32_TOKENIZE_REL_L2_TOL
                and ids >= F32_TOKENIZE_SAME and lvl0 >= F32_TOKENIZE_SAME):
            fail("f32 tokenization differs from the plain versions beyond its limits")
        del engine, tok, kernel, plain
        gc.collect()
        torch.cuda.empty_cache()

        # the inference runs
        hop = 320
        for label, (out_path, proc) in started.items():
            text, _ = proc.communicate(timeout=CLI_TIMEOUT_S)
            print(f"cli (h) {label}: exit {proc.returncode}; output:\n{text.strip()}", flush=True)
            if proc.returncode != 0:
                fail(f"{label}: exit code {proc.returncode}")
            _, ran, idle = runs[label]
            check_kernels(label, launch_line(text), ran, idle)
            wrote = [line for line in text.splitlines() if line.startswith("wrote ")]
            want_files = 3 if "--text_file" in label else 1
            if len(wrote) != want_files:
                fail(f"{label}: wrote {len(wrote)} files, want {want_files}")
            for line in wrote:
                path = line[len("wrote "):].split(": ")[0]
                sr, pcm = wavfile.read(path)
                info = line[line.rindex("(") + 1:-1]
                if "chunk frames" in info:
                    frames = json.loads(info.split("chunk frames ")[1])
                    want = join_waveforms([np.zeros(f * hop, np.float32) for f in frames], sr,
                                          crossfade_ms=30.0).shape[0]
                    if len(frames) < 3:
                        fail(f"{label}: {len(frames)} chunks, want 3 or more")
                else:
                    frames = [int(info.split(", ")[1].split()[0])]
                    want = frames[0] * hop
                if "--one_shot" in label and frames != [250]:
                    fail(f"{label}: {frames} frames, want the given 250")
                rms = float(np.sqrt(np.mean(pcm.astype(np.float64) ** 2))) if pcm.size else 0.0
                print(f"cli (h) {label}: {path}: {sr} Hz, {pcm.size} samples (want {want} from "
                      f"frames {frames}), rms {rms:.1f}", flush=True)
                if sr != 16000 or pcm.dtype != np.int16 or pcm.size != want or pcm.size == 0:
                    fail(f"{label}: {path}: {sr} Hz {pcm.dtype} {pcm.size} samples, want {want}")
                if (pcm == -32768).any() or not rms > 0:
                    fail(f"{label}: {path}: non-finite (-32768) or silent samples")

        # the servers
        for dtype, (base, proc) in servers.items():
            label = f"serve {dtype} int8"
            deadline = time.perf_counter() + CLI_TIMEOUT_S
            while True:
                if proc.poll() is not None:
                    fail(f"{label}: exited with {proc.returncode} before serving:\n"
                         f"{proc.stdout.read()[-3000:]}")
                try:
                    with urllib.request.urlopen(f"{base}/healthz", timeout=5) as r:
                        health = json.loads(r.read())
                    break
                except OSError:
                    if time.perf_counter() > deadline:
                        fail(f"{label}: no /healthz within {CLI_TIMEOUT_S} s")
                    time.sleep(1.0)
            if health != {"ok": True, "speakers": ["alice"]}:
                fail(f"{label}: /healthz {health}")
            status, data, lat = post_json(base, "/synthesize", {
                "text": "Hello from the served CLI.", "speaker": "alice", "gt_length": 150})
            sr, pcm = wavfile.read(io.BytesIO(data)) if status == 200 else (0, np.zeros(0))
            if status != 200 or sr != 16000 or pcm.shape != (150 * hop,) or (pcm == -32768).any() \
                    or not np.abs(pcm).max() > 0:
                fail(f"{label}: /synthesize HTTP {status}, {sr} Hz, {pcm.shape}")
            body = {"name": "bob", "sample_rate": 24000,
                    "pcm_b64": base64.b64encode(wav24.astype("<f4").tobytes()).decode()}
            status_spk, _, lat_spk = post_json(base, "/speakers", body)
            with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
                health = json.loads(r.read())
            with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
                stats = json.loads(r.read())
            print(f"cli (h) {label}: /synthesize {lat:.3f} s, /speakers {status_spk} "
                  f"{lat_spk:.3f} s, /healthz {health}, /stats {stats}", flush=True)
            if status_spk != 200 or health != {"ok": True, "speakers": ["alice", "bob"]}:
                fail(f"{label}: /speakers HTTP {status_spk}, /healthz {health}")
            proc.send_signal(signal.SIGTERM)
            text, _ = proc.communicate(timeout=120)
            print(f"cli (h) {label}: SIGTERM -> exit {proc.returncode}; output:\n{text.strip()}",
                  flush=True)
            if proc.returncode != 0:
                fail(f"{label}: exit code {proc.returncode} after SIGTERM")
            ran = (BF16_KERNELS + ("int8_dense",) if dtype == "bfloat16"
                   else F32_KERNELS + ("int8_dense_f32",))
            check_kernels(label, launch_line(text), ran,
                          NOT_BF16 if dtype == "bfloat16" else NOT_F32)
        return counts
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def training_path(torch, ops, dev, smi: str) -> dict:
    """(d): the s2a recipe at full width through ``run_s2a.main_from_dict``."""
    import tempfile

    import numpy as np

    from edm_tts_tpu_torch.kernels import all_launches, reset_launches
    from edm_tts_tpu_torch.profile_synthesis import s2a_train_recipe
    from edm_tts_tpu_torch.train import run_s2a

    tmp = tempfile.mkdtemp(prefix="chip_smoke_s2a_")
    try:
        shards = os.path.join(tmp, "shards")
        write_s2a_shards(shards)
        raw = s2a_train_recipe(os.path.join(tmp, "out"), shards, SEED, TRAIN_STEPS)
        micro = raw["per_device_train_batch_size"] // raw["micro_batches"]

        # one micro-batch's loss and gradient: K3 + K4 against the plain
        # attention, on the seeded init main_from_dict starts from
        model = run_s2a.build_model(raw, dev)
        cfg = model.cfg
        frames = int(raw["training_segment_length"] * cfg.codec.sample_rate / cfg.codec.hop_length)
        before = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
        batch = next(run_s2a.code_batch_iterator(shards, frames, micro, SEED))
        ac, sem = (torch.as_tensor(batch[k], device=dev)
                   for k in ("acoustic_tokens", "semantic_tokens"))
        mask = ops.cosine_schedule_mask(torch.Generator(device=dev).manual_seed(SEED),
                                        micro, frames, device=dev)

        def loss(m):
            with torch.autocast("cuda", dtype=torch.bfloat16):
                return m.forward_train(ac, sem, mask_override=mask, train=False)["loss"]

        check_counts = attention_gradient_check(
            torch, ops, model, loss, f"train (d) one micro-batch B{micro} x {frames}")
        del model
        depth = cfg.encoder_num_layers
        if check_counts["attention"] != depth or check_counts["attention_bwd"] != depth:
            fail(f"one micro-batch launched {check_counts}, want {depth} of K3 and of K4")

        # the main path: 6 optimizer steps of B32 x 768 in 4 micro-batches
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        free = shutil.disk_usage(tmp).free
        reset_launches()
        t0 = time.perf_counter()
        trainer = run_s2a.main_from_dict(raw, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = all_launches()
        peak = torch.cuda.max_memory_allocated()
        steps = [r for r in trainer.history if "train/loss" in r]
        losses = [r["train/loss"] for r in steps]
        norms = [r["train/grad_norm"] for r in steps]
        step_s = [1.0 / r["train/steps_per_sec"] for r in steps]
        med = statistics.median(step_s[1:])  # the first step warms up
        n_micro = raw["micro_batches"]
        want = no_launches(attention=depth * n_micro * TRAIN_STEPS,
                           attention_bwd=depth * n_micro * TRAIN_STEPS)
        save = trainer.last_save
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(save["path"]) for f in fs)
        after = trainer.model.state_dict()
        codec_same = all(torch.equal(before[k], after[k].cpu())
                         for k in before if k.startswith("acoustic_model."))
        trainable = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
        still = [n for n in trainable if torch.equal(before[n], after[n].cpu())]
        print(f"train (d) {len(steps)} steps of B{raw['per_device_train_batch_size']} x "
              f"{frames} frames ({n_micro} micro-batches), {len(trainable)} trainable tensors "
              f"({sum(p.numel() for p in trainer.optimizer.params) / 1e6:.1f}M): losses "
              f"{[round(x, 4) for x in losses]} grad norms {[round(x, 4) for x in norms]} "
              f"lr {[r['train/lr'] for r in steps]}", flush=True)
        print(f"train (d) step seconds {[round(x, 4) for x in step_s]}: median {med:.4f} s "
              f"after the first, {raw['per_device_train_batch_size'] * frames / med:.1f} frames "
              f"per s; wall {wall:.2f} s with set-up, checkpoint and export; peak device memory "
              f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated); final checkpoint "
              f"{ckpt_bytes / 2 ** 30:.2f} GiB saved in {save['seconds']:.2f} s (disk free "
              f"before {free / 2 ** 30:.1f} GiB); launches {counts} expected {want} ({smi})",
              flush=True)
        if not all(np.isfinite(losses + norms)) or len(steps) != TRAIN_STEPS:
            fail(f"training: {len(steps)} steps, losses {losses}, grad norms {norms}")
        if not codec_same:
            fail("training changed the frozen codec's weights")
        if still:
            fail(f"training left trainable tensors unchanged: {still[:5]}")
        if counts != want:
            fail(f"training launches {counts} != expected {want}")
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def t2s_training_path(torch, ops, dev, smi: str) -> dict:
    """(e): the t2s recipe at full width through ``run_t2s.main_from_dict``."""
    import tempfile

    import numpy as np

    from edm_tts_tpu_torch.kernels import all_launches, reset_launches
    from edm_tts_tpu_torch.profile_synthesis import t2s_train_recipe
    from edm_tts_tpu_torch.train import run_t2s

    tmp = tempfile.mkdtemp(prefix="chip_smoke_t2s_")
    try:
        shards = os.path.join(tmp, "shards")
        write_t2s_shards(shards)
        raw = t2s_train_recipe(os.path.join(tmp, "out"), shards, SEED, TRAIN_STEPS)
        model = run_t2s.build_model(raw, dev)
        cfg = model.cfg
        depth = cfg.main_encoder_num_layers + cfg.length_predictor_num_layers
        before = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}

        # one batch of 8 (the plain attention keeps B x H x T x T scores),
        # the longest canvas of the iterator's first 8: K3 + K4 against the
        # plain attention
        batch = max(itertools.islice(run_t2s.t2s_batch_iterator(shards, 8, SEED), 8),
                    key=lambda b: b["input_ids"].shape[1])
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        mask = ops.cosine_schedule_mask(torch.Generator(device=dev).manual_seed(SEED),
                                        *batch["input_ids"].shape, device=dev)

        def loss(m):
            with torch.autocast("cuda", dtype=torch.bfloat16):
                return m.forward_train(*(batch[k] for k in run_t2s.BATCH_KEYS),
                                       mask_override=mask, train=False)["loss"]

        check_counts = attention_gradient_check(
            torch, ops, model, loss, f"train (e) one batch B8 x {batch['input_ids'].shape[1]}")
        del model
        if check_counts["attention"] != depth or check_counts["attention_bwd"] != depth:
            fail(f"one t2s batch launched {check_counts}, want {depth} of K3 and of K4")

        # the main path: 6 optimizer steps of B32; the iterator is seeded, so
        # the same iterator gives the canvases the trainer takes
        shapes = [(b["input_ids"].shape, b["text_ids"].shape[1] + 1) for b in itertools.islice(
            run_t2s.t2s_batch_iterator(shards, raw["per_device_train_batch_size"], SEED),
            TRAIN_STEPS)]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        trainer = run_t2s.main_from_dict(raw, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = all_launches()
        peak = torch.cuda.max_memory_allocated()
        steps = [r for r in trainer.history if "train/loss" in r]
        losses = [r["train/loss"] for r in steps]
        norms = [r["train/grad_norm"] for r in steps]
        step_s = [1.0 / r["train/steps_per_sec"] for r in steps]
        tokens = [shape[0] * shape[1] for shape, _ in shapes]
        med = statistics.median(step_s[1:])  # the first step warms up
        rate = sum(tokens[1:]) / sum(step_s[1:])
        want = no_launches(attention=depth * TRAIN_STEPS, attention_bwd=depth * TRAIN_STEPS)
        after = trainer.model.state_dict()
        trainable = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
        still = [n for n in trainable if torch.equal(before[n], after[n].cpu())]
        canvases = sorted({shape[1] for shape, _ in shapes})
        print(f"train (e) {len(steps)} steps of B{raw['per_device_train_batch_size']}, canvases "
              f"(main x length predictor) {[(s[1], lp) for s, lp in shapes]}, "
              f"{len(trainable)} trainable tensors "
              f"({sum(p.numel() for p in trainer.optimizer.params) / 1e6:.1f}M): losses "
              f"{[round(x, 4) for x in losses]} (CE {[round(r['train/ce_loss'], 4) for r in steps]},"
              f" length {[round(r['train/length_loss'], 4) for r in steps]}) grad norms "
              f"{[round(x, 4) for x in norms]} lr {[r['train/lr'] for r in steps]}", flush=True)
        print(f"train (e) step seconds {[round(x, 4) for x in step_s]}: median {med:.4f} s "
              f"after the first, {rate:.1f} canvas tokens per s (steps 2-{TRAIN_STEPS}); wall "
              f"{wall:.2f} s with set-up, checkpoint and export; peak device memory "
              f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated); launches {counts} expected "
              f"{want} ({smi})", flush=True)
        if not all(np.isfinite(losses + norms)) or len(steps) != TRAIN_STEPS:
            fail(f"t2s training: {len(steps)} steps, losses {losses}, grad norms {norms}")
        if still:
            fail(f"t2s training left trainable tensors unchanged: {still[:5]}")
        if counts != want:
            fail(f"t2s training launches {counts} != expected {want}")
        if len(canvases) < 2 or any(s[1] % 64 or (lp - 1) % 64 for s, lp in shapes):
            fail(f"t2s canvases {shapes}: want at least two lengths, multiples of 64 (+1)")
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def f32_training_path(torch, ops, dev, smi: str) -> dict:
    """(i): the s2a and t2s recipes at f32 (``bf16: false``) at full width.

    One s2a micro-batch (B8 x 768) through K3-f32 + K4-f32 against the plain
    f32 attention, and under the remat policies "mha" (K3-f32's outputs kept:
    no extra launch) and "full"; then TRAIN_F32_STEPS steps of the s2a
    recipe (B32 x 768 in 4 micro-batches) with ``watch: all`` and the
    tracker of TRACKER_SPEC, and TRAIN_F32_STEPS steps of the t2s recipe.
    Returns the launches of the two runs."""
    import dataclasses
    import tempfile

    import numpy as np

    from edm_tts_tpu_torch.kernels import all_launches, reset_launches
    from edm_tts_tpu_torch.profile_synthesis import s2a_train_recipe, t2s_train_recipe
    from edm_tts_tpu_torch.train import run_s2a, run_t2s

    tmp = tempfile.mkdtemp(prefix="chip_smoke_f32_")
    try:
        shards = os.path.join(tmp, "shards")
        write_s2a_shards(shards)
        raw = s2a_train_recipe(os.path.join(tmp, "out"), shards, SEED, TRAIN_F32_STEPS)
        raw.update(bf16=False, watch="all", trackers=[TRACKER_SPEC])
        n_micro = raw["micro_batches"]
        micro = raw["per_device_train_batch_size"] // n_micro
        model = run_s2a.build_model(raw, dev)
        cfg = model.cfg
        depth = cfg.encoder_num_layers
        frames = int(raw["training_segment_length"] * cfg.codec.sample_rate / cfg.codec.hop_length)
        batch = next(run_s2a.code_batch_iterator(shards, frames, micro, SEED))
        ac, sem = (torch.as_tensor(batch[k], device=dev)
                   for k in ("acoustic_tokens", "semantic_tokens"))
        mask = ops.cosine_schedule_mask(torch.Generator(device=dev).manual_seed(SEED),
                                        micro, frames, device=dev)

        def loss(m):
            return m.forward_train(ac, sem, mask_override=mask, train=False)["loss"]

        counts = attention_gradient_check(
            torch, ops, model, loss, f"train (i) one f32 micro-batch B{micro} x {frames}",
            tols=(TRAIN_F32_GRAD_REL_L2_TOL, TRAIN_F32_LOSS_REL_TOL))
        want = no_launches(attention_f32=depth, attention_bwd_f32=depth)
        if counts != want:
            fail(f"one f32 micro-batch launched {counts}, want {want}")

        # the remat policies at f32: "mha" keeps K3-f32's outputs
        def grad_under(policy):
            model.cfg = dataclasses.replace(cfg, gradient_checkpointing=policy is not None,
                                            remat_policy=policy or cfg.remat_policy)
            model.zero_grad(set_to_none=True)
            reset_launches()
            with torch.enable_grad():
                loss(model).backward()
            torch.cuda.synchronize()
            grad = torch.cat([p.grad.flatten() for p in model.parameters() if p.requires_grad])
            model.zero_grad(set_to_none=True)
            return grad, all_launches()

        ref, _ = grad_under(None)
        for policy, k3 in (("mha", depth), ("full", 2 * depth)):
            grad, counts = grad_under(policy)
            rel = rel_l2(torch, grad, ref)
            want = no_launches(attention_f32=k3, attention_bwd_f32=depth)
            print(f"train (i) remat {policy} at f32: gradient relative l2 to no remat {rel:.3g} "
                  f"(tol {TRAIN_F32_GRAD_REL_L2_TOL}); launches {counts} expected {want}",
                  flush=True)
            if not rel <= TRAIN_F32_GRAD_REL_L2_TOL or counts != want:
                fail(f"remat {policy} at f32: gradient {rel}, launches {counts} != {want}")
        model.cfg = cfg
        del model, ref, grad
        gc.collect()
        torch.cuda.empty_cache()

        # the main path: the s2a recipe at f32 with watch and a tracker
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        trainer = run_s2a.main_from_dict(raw, device=dev)
        torch.cuda.synchronize()
        counts_s2a = all_launches()
        peak = torch.cuda.max_memory_allocated()
        steps = [r for r in trainer.history if "train/loss" in r]
        step_s = [1.0 / r["train/steps_per_sec"] for r in steps]
        losses = [r["train/loss"] for r in steps]
        med = statistics.median(step_s[1:])
        want = no_launches(attention_f32=depth * n_micro * TRAIN_F32_STEPS,
                           attention_bwd_f32=depth * n_micro * TRAIN_F32_STEPS)
        tracker = trainer.metrics.trackers[0]
        names = [n for n, _ in trainer.optimizer.named]
        watched = [{k: v for k, v in scalars.items() if k.startswith("train/watch/")}
                   for _, scalars in tracker.scalars]
        print(f"train (i) s2a f32 {len(steps)} steps of B{raw['per_device_train_batch_size']} x "
              f"{frames} ({n_micro} micro-batches): losses {[round(x, 5) for x in losses]} "
              f"grad norms {[round(r['train/grad_norm'], 5) for r in steps]}; step seconds "
              f"{[round(x, 4) for x in step_s]}: median {med:.4f} s after the first, "
              f"{raw['per_device_train_batch_size'] * frames / med:.1f} frames per s; peak device "
              f"memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated); launches {counts_s2a} "
              f"expected {want} ({smi})", flush=True)
        print(f"train (i) s2a f32 watch: {len(watched[0]) if watched else 0} norms a step for "
              f"{len(names)} trainable tensors reached the tracker in {len(tracker.scalars)} "
              f"records; e.g. {dict(list(watched[0].items())[:2]) if watched else {}}", flush=True)
        if len(steps) != TRAIN_F32_STEPS or not all(np.isfinite(losses)):
            fail(f"f32 s2a training: {len(steps)} steps, losses {losses}")
        if counts_s2a != want:
            fail(f"f32 s2a training launches {counts_s2a} != expected {want}")
        if (len(watched) != TRAIN_F32_STEPS or any(len(w) != 2 * len(names) for w in watched)
                or not all(math.isfinite(v) for w in watched for v in w.values())
                or any(f"train/watch/grad_norm/{n}" not in watched[0] for n in names)):
            fail("f32 s2a training: the watch norms did not all reach the tracker, finite")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        # the t2s recipe at f32
        t2s_shards = os.path.join(tmp, "t2s_shards")
        write_t2s_shards(t2s_shards)
        raw = t2s_train_recipe(os.path.join(tmp, "t2s_out"), t2s_shards, SEED, TRAIN_F32_STEPS)
        raw.update(bf16=False)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        trainer = run_t2s.main_from_dict(raw, device=dev)
        torch.cuda.synchronize()
        counts_t2s = all_launches()
        depth = trainer.model.cfg.main_encoder_num_layers + \
            trainer.model.cfg.length_predictor_num_layers
        peak = torch.cuda.max_memory_allocated()
        steps = [r for r in trainer.history if "train/loss" in r]
        step_s = [1.0 / r["train/steps_per_sec"] for r in steps]
        losses = [r["train/loss"] for r in steps]
        want = no_launches(attention_f32=depth * TRAIN_F32_STEPS,
                           attention_bwd_f32=depth * TRAIN_F32_STEPS)
        print(f"train (i) t2s f32 {len(steps)} steps of B{raw['per_device_train_batch_size']}: "
              f"losses {[round(x, 5) for x in losses]}; step seconds "
              f"{[round(x, 4) for x in step_s]}; peak device memory {peak / 2 ** 30:.2f} GiB "
              f"(max_memory_allocated); launches {counts_t2s} expected {want} ({smi})",
              flush=True)
        if len(steps) != TRAIN_F32_STEPS or not all(np.isfinite(losses)):
            fail(f"f32 t2s training: {len(steps)} steps, losses {losses}")
        if counts_t2s != want:
            fail(f"f32 t2s training launches {counts_t2s} != expected {want}")
        return {k: counts_s2a[k] + counts_t2s[k] for k in counts_s2a}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def write_preprocess_data(root, encode_flac) -> None:
    """(j)'s seeded audio under ``root``: LibriSpeech train-clean-100 (4
    speakers x PREPROCESS_UTTERANCES / 4 utterances of U(3, 15) s, with
    transcripts) and LibriLight small (two books of LIBRILIGHT_BOOK_SECONDS,
    written with verbatim FLAC subframes, which encode fastest)."""
    import numpy as np

    from edm_tts_tpu_torch.profile_tokenization import prompt_wav

    def pcm(seconds, seed):
        return np.round(np.clip(prompt_wav(seconds, seed, 16000), -1, 1) * 32767).astype(np.int64)

    rng = np.random.default_rng(SEED + 90)
    per = PREPROCESS_UTTERANCES // 4
    for spk in range(4):
        folder = root / "LibriSpeech" / "train-clean-100" / str(100 + spk) / "7"
        folder.mkdir(parents=True)
        lines = []
        for i in range(per):
            uid = f"{100 + spk}-7-{i:04d}"
            (folder / f"{uid}.flac").write_bytes(encode_flac(
                pcm(float(rng.uniform(3.0, 15.0)), SEED + 100 + spk * per + i)[None], 16000))
            lines.append(f"{uid} UTTERANCE {i} OF SPEAKER {spk}")
        (folder / f"{100 + spk}-7.trans.txt").write_text("\n".join(lines) + "\n")
    for book in range(2):
        path = root / "small" / str(200 + book) / "book" / f"book{book}.flac"
        path.parent.mkdir(parents=True)
        path.write_bytes(encode_flac(pcm(LIBRILIGHT_BOOK_SECONDS, SEED + 150 + book)[None], 16000,
                                     blocksize=4096, subframe_kind="verbatim"))


def preprocessing_path(torch, dev, smi: str) -> dict:
    """(j): offline preprocessing at full width. Writes (j)'s seeded audio,
    a full-width f32 HuBERT-large as an HF directory and the default codec
    (seeded as (c)'s) as a reference directory; runs ``python -m
    edm_tts_tpu_torch.hubert_kmeans`` (layer 18, K 1024, its defaults) on
    the LibriSpeech set into a new HuBERT directory, then ``python -m
    edm_tts_tpu_torch.dump_tokens`` (bf16, B8 x 60 s windows) on the
    LibriLight set with that codec and HuBERT; checks each CLI's kernel
    launches and the shards, then reads the shards with
    ``run_s2a.code_batch_iterator`` and takes one step of the s2a recipe
    (B8 x 768, one micro-batch) on them, counted; last, the k-means fit
    itself at the CLI's default size on seeded features. Returns the
    launches of the two CLIs and of the step."""
    import tempfile

    import numpy as np

    from edm_tts_tpu_torch.data.token_shards import iter_token_shards
    from edm_tts_tpu_torch.kernels import all_launches, reset_launches
    from edm_tts_tpu_torch.ops.kmeans import kmeans
    from edm_tts_tpu_torch.profile_synthesis import s2a_train_recipe
    from edm_tts_tpu_torch.profile_tokenization import full_width_codec, full_width_semantic
    from edm_tts_tpu_torch.train import run_s2a
    from edm_tts_tpu_torch.utils import hub

    root = Path(__file__).resolve().parent
    from edm_tts_tpu_torch.data.flac_encoder import encode_flac

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_preprocess_"))
    try:
        t0 = time.perf_counter()
        data = tmp / "data"
        write_preprocess_data(data, encode_flac)
        semantic = full_width_semantic(dev, SEED + 91, dtype=torch.float32)
        hub.save_hubert_hf(str(tmp / "hubert_hf"), semantic, centroids="centroids.npy")
        depth, hidden = semantic.output_layer, semantic.config.hidden_size
        codec = full_width_codec(dev, SEED, dtype=torch.float32)
        hub.save_reference(str(tmp / "codec"), codec)
        levels, codes = codec.config.n_codebooks, codec.config.codebook_size
        del semantic, codec
        gc.collect()
        torch.cuda.empty_cache()
        print(f"preprocess (j): {PREPROCESS_UTTERANCES} LibriSpeech utterances, two "
              f"{LIBRILIGHT_BOOK_SECONDS:.0f} s LibriLight books and the model directories "
              f"written in {time.perf_counter() - t0:.2f} s", flush=True)

        def cli(module, *args) -> tuple[dict, str, float]:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", f"edm_tts_tpu_torch.{module}", *args],
                                  cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True, timeout=CLI_TIMEOUT_S)
            wall = time.perf_counter() - t0
            tail = "\n".join(line for line in proc.stdout.splitlines()
                             if not line.startswith("kernel launches"))[-3000:]
            print(f"preprocess (j) {module}: exit {proc.returncode} in {wall:.2f} s; output:\n"
                  f"{tail}", flush=True)
            if proc.returncode != 0:
                fail(f"{module}: exit code {proc.returncode}")
            return launch_line(proc.stdout), proc.stdout, wall

        # the codebook: HuBERT-large f32 to layer 18 over the LibriSpeech set
        hubert_dir = tmp / "hubert"
        counts_k, _, _ = cli("hubert_kmeans", "--data_dir", str(data), "--hubert_model",
                             str(tmp / "hubert_hf"), "--output", str(hubert_dir))
        want = no_launches(attention_f32=depth * PREPROCESS_UTTERANCES)
        print(f"preprocess (j) hubert_kmeans: launches {counts_k} expected {want}", flush=True)
        if counts_k != want:
            fail(f"hubert_kmeans launches {counts_k} != expected {want}")
        centers = np.load(hub.find_centroids(str(hubert_dir)))
        if centers.shape != (1024, hidden) or not np.isfinite(centers).all():
            fail(f"hubert_kmeans wrote centroids {centers.shape}, finite "
                 f"{np.isfinite(centers).all()}")

        # the dump: one batch of 8 windows of 60 s, bf16
        shards = tmp / "shards"
        counts_d, out, wall = cli("dump_tokens", "--dataset", "librilight", "--data_dir", str(data),
                                  "--subset", "small", "--output_dir", str(shards),
                                  "--codec_model", str(tmp / "codec"),
                                  "--hubert_model", str(hubert_dir))
        want = no_launches(resunit=12, attention=depth)
        done = [line for line in out.splitlines() if " done: " in line][-1]
        n_items, seconds = int(done.split("done: ")[1].split()[0]), float(
            done.split(" in ")[1].rstrip("s"))
        print(f"preprocess (j) dump_tokens: {n_items} items of {DUMP_WINDOW_SECONDS:.0f} s in "
              f"{seconds:.2f} s of its loop ({n_items / seconds:.3f} items per s, "
              f"{n_items * DUMP_WINDOW_SECONDS / seconds:.1f} audio s per s; {wall:.2f} s of "
              f"process wall with start-up and model loads); launches {counts_d} expected "
              f"{want} ({smi})", flush=True)
        if counts_d != want:
            fail(f"dump_tokens launches {counts_d} != expected {want}")
        items = list(iter_token_shards(str(shards)))
        frames = int(DUMP_WINDOW_SECONDS * 50)
        bad = [it["id"] for it in items
               if it["acoustic_tokens"].shape != (levels, frames)
               or it["semantic_tokens"].shape != (frames,)
               or not (0 <= it["acoustic_tokens"]).all() or not (it["acoustic_tokens"] < codes).all()
               or not (0 <= it["semantic_tokens"]).all() or not (it["semantic_tokens"] < 1024).all()]
        distinct = len(np.unique(np.concatenate([it["semantic_tokens"] for it in items])))
        print(f"preprocess (j) shards: {len(items)} items, codes ({levels}, {frames}) and ({frames},) "
              f"in range: {not bad}; {distinct} distinct semantic ids", flush=True)
        if len(items) != DUMP_BATCH or bad:
            fail(f"dump_tokens wrote {len(items)} items, malformed: {bad}")

        # the trainers read the shards: one step of the s2a recipe on them
        raw = s2a_train_recipe(str(tmp / "s2a_out"), str(shards), SEED, 1)
        raw.update(per_device_train_batch_size=DUMP_BATCH, micro_batches=1)
        segment = int(raw["training_segment_length"] * 50)
        batch = next(run_s2a.code_batch_iterator(str(shards), segment, DUMP_BATCH, SEED))
        if batch["acoustic_tokens"].shape != (DUMP_BATCH, levels, segment):
            fail(f"code_batch_iterator on the dump: {batch['acoustic_tokens'].shape}")
        reset_launches()
        trainer = run_s2a.main_from_dict(raw, device=dev)
        torch.cuda.synchronize()
        counts_s = all_launches()
        steps = [r for r in trainer.history if "train/loss" in r]
        layers = trainer.model.cfg.encoder_num_layers
        want = no_launches(attention=layers, attention_bwd=layers)
        print(f"preprocess (j) one s2a step of B{DUMP_BATCH} x {segment} on the dumped shards: "
              f"loss {[r['train/loss'] for r in steps]}; launches {counts_s} expected {want}",
              flush=True)
        if len(steps) != 1 or not math.isfinite(steps[0]["train/loss"]) or counts_s != want:
            fail(f"the s2a step on the dump: {steps}, launches {counts_s}")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        # the fit at the CLI's default size: 1024 x 1000 seeded f32 frames
        # of D 1024 around 1024 seeded centers
        gen = torch.Generator(device=dev).manual_seed(SEED + 92)
        k, dim = KMEANS_K, KMEANS_DIM
        x = torch.randn(k, dim, generator=gen, device=dev)[torch.randint(
            k, (k * KMEANS_FRAMES_PER_CLUSTER,), generator=gen, device=dev)]
        x.add_(torch.randn(x.shape, generator=gen, device=dev), alpha=0.7)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        history: list = []
        fitted, inertia = kmeans(x, k, history=history)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        rises = [max((b - a) / a for a, b in zip(h, h[1:])) for h in history]
        print(f"preprocess (j) kmeans fit at the CLI's default size: x {tuple(x.shape)} f32 "
              f"({x.numel() * 4 / 2 ** 30:.2f} GiB), K {k}, niter {len(history[0])}, nredo "
              f"{len(history)} in {fit_s:.2f} s "
              f"({fit_s / sum(map(len, history)) * 1e3:.1f} ms per Lloyd iteration); inertia "
              f"{float(inertia):.6g}; per run first -> last {[(h[0], h[-1]) for h in history]}; "
              f"largest relative rise {max(rises):.3g} (tol {KMEANS_INERTIA_RISE_TOL}); peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({smi})",
              flush=True)
        if not (max(rises) <= KMEANS_INERTIA_RISE_TOL and torch.isfinite(fitted).all()
                and len(history) == 5):
            fail(f"kmeans: inertia rose by {max(rises)} or the centers are not finite")
        del x, fitted
        torch.cuda.empty_cache()
        return {name: counts_k[name] + counts_d[name] + counts_s[name] for name in KERNELS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def remat_path(torch, dev, smi: str) -> dict:
    """Gradient checkpointing on the full-width s2a: one B8 x 768 micro-batch
    with dropout 0.1 under each policy against no remat, then 2 steps of
    the recipe as B32 in one micro-batch under "mha"."""
    import dataclasses
    import tempfile

    from edm_tts_tpu_torch.kernels import all_launches, reset_launches
    from edm_tts_tpu_torch.profile_synthesis import s2a_train_recipe
    from edm_tts_tpu_torch.train import run_s2a

    tmp = tempfile.mkdtemp(prefix="chip_smoke_remat_")
    try:
        shards = os.path.join(tmp, "shards")
        write_s2a_shards(shards)
        raw = s2a_train_recipe(os.path.join(tmp, "out"), shards, SEED, 2)
        raw["extra_model_params"]["encoder_config"].update(
            ff_dropout=REMAT_DROPOUT, conv_dropout=REMAT_DROPOUT)
        model = run_s2a.build_model(raw, dev)
        cfg = model.cfg
        frames = int(raw["training_segment_length"] * cfg.codec.sample_rate / cfg.codec.hop_length)
        micro = raw["per_device_train_batch_size"] // raw["micro_batches"]
        batch = next(run_s2a.code_batch_iterator(shards, frames, micro, SEED))
        ac, sem = (torch.as_tensor(batch[k], device=dev)
                   for k in ("acoustic_tokens", "semantic_tokens"))
        depth = cfg.encoder_num_layers
        ref = None
        for policy in (None, "full", "mha", "dots"):
            model.cfg = dataclasses.replace(cfg, gradient_checkpointing=policy is not None,
                                            remat_policy=policy or cfg.remat_policy)
            model.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
            static = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            gen = torch.Generator(device=dev).manual_seed(SEED + 40)
            with torch.enable_grad():
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    loss = model.forward_train(ac, sem, generator=gen)["loss"]
                loss.backward()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            counts = all_launches()
            grad = torch.cat([p.grad.flatten() for p in model.parameters() if p.requires_grad])
            model.zero_grad(set_to_none=True)
            rel = 0.0 if ref is None else rel_l2(torch, grad, ref)
            if ref is None:
                ref = grad
            want = no_launches(attention=depth * (2 if policy == "full" else 1),
                               attention_bwd=depth)
            print(f"remat {policy or 'none'}: one micro-batch B{micro} x {frames}, dropout "
                  f"{REMAT_DROPOUT}: loss {loss.item():.6f}, gradient relative l2 to no remat "
                  f"{rel:.3g} (tol {REMAT_GRAD_REL_L2_TOL}); peak device memory "
                  f"{peak / 2 ** 30:.2f} GiB, {(peak - static) / 2 ** 30:.2f} GiB above the "
                  f"weights (max_memory_allocated); launches {counts} expected {want}", flush=True)
            if not rel <= REMAT_GRAD_REL_L2_TOL:
                fail(f"remat {policy}: gradient differs from no remat by {rel}")
            if counts != want:
                fail(f"remat {policy}: launches {counts} != expected {want}")
        del model, ref, grad
        torch.cuda.empty_cache()

        # the recipe's B32 in one micro-batch under "mha"
        raw = s2a_train_recipe(os.path.join(tmp, "out_b32"), shards, SEED, 2)
        raw.update(micro_batches=1)
        raw["extra_model_params"].update(gradient_checkpointing=True, remat_policy="mha")
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        trainer = run_s2a.main_from_dict(raw, device=dev)
        torch.cuda.synchronize()
        counts = all_launches()
        peak = torch.cuda.max_memory_allocated()
        steps = [r for r in trainer.history if "train/loss" in r]
        step_s = [1.0 / r["train/steps_per_sec"] for r in steps]
        want = no_launches(attention=2 * depth, attention_bwd=2 * depth)
        print(f"remat mha: 2 steps of B32 x {frames} in one micro-batch: losses "
              f"{[round(r['train/loss'], 4) for r in steps]}, step seconds "
              f"{[round(x, 4) for x in step_s]} ({32 * frames / step_s[-1]:.1f} frames per s "
              f"at the second), peak device memory {peak / 2 ** 30:.2f} GiB "
              f"(max_memory_allocated); launches {counts} expected {want} ({smi})", flush=True)
        if len(steps) != 2 or not all(math.isfinite(r["train/loss"]) for r in steps):
            fail(f"remat mha B32: {steps}")
        if counts != want:
            fail(f"remat mha B32: launches {counts} != expected {want}")
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ablation_path(torch, smi: str) -> tuple[dict, list]:
    """(f): K6 through the profiling script's sweep at its shape."""
    from edm_tts_tpu_torch.kernels import all_launches, reset_launches
    from edm_tts_tpu_torch.profile_attn_variants import inputs, sweep

    q, k, v = inputs(seed=SEED)
    reset_launches()
    rows = sweep(q, k, v, n=ABLATION_RUNS)
    torch.cuda.synchronize()
    counts = all_launches()
    want = no_launches(attn_variants=len(rows) * (ABLATION_RUNS + 1))
    for row in rows:
        print(f"ablation (f) B{q.shape[0]} T{q.shape[1]} H{q.shape[2]} D{q.shape[3]} "
              f"{row['variant']} block_q {row['block_q']}: {row['ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}) ({smi})", flush=True)
    print(f"ablation (f): launches {counts} expected {want}", flush=True)
    if counts != want:
        fail(f"ablation launches {counts} != expected {want}")
    return counts, rows


def source_faults() -> int:
    """``--source-faults``: the ``--attention-kernels``, ``--int8-kernels`` and
    ``--codec-kernels`` cases of the kernel phase on the sources as they are
    (which must pass),
    then for each of SOURCE_FAULTS the cases of its kernel on a copy of the
    package and of this script in a temporary directory with that one edit,
    built there; each must be rejected."""
    import tempfile

    root = Path(__file__).resolve().parent
    pkg = root / "edm_tts_tpu_torch"

    def child(source: str) -> list:
        return [sys.executable, "chip_smoke.py", FAULT_MODES.get(source, "--attention-kernels")]

    print("source faults: the sources as they are (must pass)", flush=True)
    for source in ("attention.cu", "qdense.cu", "conv_gemm.cuh", "qdense_f32.cu"):
        if subprocess.run(child(source), cwd=root, timeout=600).returncode != 0:
            fail(f"the {child(source)[-1]} cases reject the sources as they are")
    passed = []
    for name, (source, edits) in SOURCE_FAULTS.items():
        with tempfile.TemporaryDirectory(prefix="chip_smoke_fault_") as tmp:
            shutil.copytree(pkg, Path(tmp) / pkg.name,
                            ignore=shutil.ignore_patterns("_build", "__pycache__"))
            shutil.copy2(root / "chip_smoke.py", tmp)
            path = Path(tmp) / pkg.name / "csrc" / source
            text = path.read_text()
            for old, new in edits:
                if old not in text:
                    fail(f"source fault {name!r}: {old!r} is not in {source}")
                text = text.replace(old, new)
            path.write_text(text)
            print(f"source fault {name!r} planted in {source}:", flush=True)
            rc = subprocess.run(child(source), cwd=tmp, timeout=600).returncode
        if rc not in (0, 3):
            fail(f"the check of source fault {name!r} did not run to its end (exit {rc})")
        print(f"source fault {name!r}: {'passed' if rc == 0 else 'rejected'}", flush=True)
        if rc == 0:
            passed.append(name)
    print(f"source faults rejected: {len(SOURCE_FAULTS) - len(passed)} of {len(SOURCE_FAULTS)}",
          flush=True)
    if passed:
        fail(f"source faults passed the cases of their kernels: {passed}")
    return 0


def write_codec_data(root, encode_flac) -> None:
    """(k)'s seeded audio under ``root`` in LibriLight's layout (verbatim FLAC
    subframes): 16 books of CODEC_VAL_BOOK_SECONDS, the recipe's held-out
    windows, then CODEC_TRAIN_BOOKS of 60 s for training."""
    import numpy as np

    from edm_tts_tpu_torch.profile_tokenization import prompt_wav

    books = [(f"{100 + i}", CODEC_VAL_BOOK_SECONDS) for i in range(CODEC_RECIPE["validation_split"])]
    books += [(f"{200 + i}", 60.0) for i in range(CODEC_TRAIN_BOOKS)]
    for i, (speaker, seconds) in enumerate(books):
        pcm = np.round(np.clip(prompt_wav(seconds, SEED + 130 + i, 16000), -1, 1) * 32767)
        path = root / "small" / speaker / "book" / f"{speaker}.flac"
        path.parent.mkdir(parents=True)
        path.write_bytes(encode_flac(pcm.astype(np.int64)[None], 16000, blocksize=4096,
                                     subframe_kind="verbatim"))


def codec_training_path(torch, ops, dev, smi: str, held_k1: set) -> dict:
    """(k): codec GAN training at full width. Writes (k)'s seeded books and
    the recipe (CODEC_RECIPE: the generator, 12 x 1024 x 8 RVQ with dropout
    0.5, MPD 2/3/5/7/11 and MRD 2048/1024/512 x 5 bands, B32 x 0.38 s, f32)
    with the steps, intervals and directories cut; runs ``python -m
    edm_tts_tpu_torch.train.run_codec`` for CODEC_TRAIN_STEPS steps (one eval,
    one save, the best generator exported), checks in this process that the
    trainer's restore of that checkpoint gives G, D and both optimizers as
    saved, and resumes it to CODEC_RESUME_STEPS; every loss finite, no kernel
    launched (f32: the plain compositions, as the JAX package's "auto" rule
    runs them). Then loads the export with ``load_codec(..., bf16)`` and
    round-trips a seeded clip through K1 and K2, held against the plain
    versions; last, the gradient of a loss on that model's encoder latents
    and decoded audio through K1 and K2 under autograd against the same
    model through the plain versions (flattened, CODEC_GRAD_REL_L2_TOL) and
    against its f32 copy's (per tensor, CODEC_GRAD_NOISE_FACTOR).
    Returns the launches of the round trip and of the gradient check."""
    import copy
    import tempfile

    from edm_tts_tpu_torch.kernels import all_launches, reset_launches, resunit_shapes
    from edm_tts_tpu_torch.models.codec.decoder import DecoderBlock
    from edm_tts_tpu_torch.models.codec.layers import ResidualUnit
    from edm_tts_tpu_torch.models.codec.losses import ReconstructionLoss
    from edm_tts_tpu_torch.profile_tokenization import prompt_wav
    from edm_tts_tpu_torch.train import run_codec
    from edm_tts_tpu_torch.train.gan_trainer import GANTrainer
    from edm_tts_tpu_torch.utils import hub

    root = Path(__file__).resolve().parent
    from edm_tts_tpu_torch.data.flac_encoder import encode_flac

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_codec_"))
    try:
        t0 = time.perf_counter()
        write_codec_data(tmp / "data", encode_flac)
        out_dir = tmp / "out"
        raw = dict(CODEC_RECIPE, output_dir=str(out_dir), logging_steps=1,
                   eval_steps=CODEC_TRAIN_STEPS, save_steps=CODEC_TRAIN_STEPS,
                   dataset_args=dict(CODEC_RECIPE["dataset_args"], data_dir=str(tmp / "data")))
        batch = raw["per_device_train_batch_size"]
        print(f"train (k): {CODEC_RECIPE['validation_split']} held-out books of "
              f"{CODEC_VAL_BOOK_SECONDS} s and {CODEC_TRAIN_BOOKS} of 60 s written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

        def run(steps: int) -> tuple[dict, int, str]:
            """run_codec to ``steps`` in a subprocess: (launches, peak bytes, output)."""
            config = tmp / "train_config.yaml"
            config.write_text(json.dumps(dict(raw, max_steps=steps)))  # JSON is YAML
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "edm_tts_tpu_torch.train.run_codec", str(config)],
                cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                timeout=CLI_TIMEOUT_S)
            tail = "\n".join(line for line in proc.stdout.splitlines()
                             if "watch/" not in line)[-2500:]
            print(f"train (k) run_codec to step {steps}: exit {proc.returncode} in "
                  f"{time.perf_counter() - t0:.2f} s; output:\n{tail}", flush=True)
            if proc.returncode != 0:
                fail(f"run_codec to step {steps}: exit code {proc.returncode}")
            peak = [line for line in proc.stdout.splitlines() if line.startswith("peak device")]
            return launch_line(proc.stdout), int(peak[-1].split()[3]), proc.stdout

        counts_1, peak_1, _ = run(CODEC_TRAIN_STEPS)

        # the resume's starting point: the trainer's restore, in this process,
        # on models of another seed, against the checkpoint as saved
        saved = torch.load(out_dir / f"checkpoint_{CODEC_TRAIN_STEPS}" / "state.pt",
                           map_location=dev, weights_only=True)
        codec, disc = run_codec.build_models(dict(raw, seed=raw["seed"] + 1), dev)
        trainer = GANTrainer(run_codec.training_arguments(raw), codec, disc,
                             ReconstructionLoss(16000), device=dev)
        start = trainer._restore()

        def leaves(tree, prefix=""):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    yield from leaves(v, f"{prefix}{k}/")
            else:
                yield prefix, tree

        restored = dict(leaves(trainer.state()))
        expected = dict(leaves(saved))
        differ = [k for k, v in expected.items()
                  if not (torch.equal(torch.as_tensor(restored[k]).to(dev),
                                      torch.as_tensor(v).to(dev)))]
        counts_opt = (trainer.g_opt.count, trainer.d_opt.count)
        print(f"train (k) resume: the restore starts at step {start} with optimizer counts "
              f"{counts_opt}; {len(expected)} tensors of G, D and both optimizers, "
              f"{len(differ)} differ from the checkpoint", flush=True)
        if start != CODEC_TRAIN_STEPS or differ or set(restored) != set(expected) or \
                counts_opt != (CODEC_TRAIN_STEPS,) * 2:
            fail(f"the restore of checkpoint {CODEC_TRAIN_STEPS}: step {start}, counts "
                 f"{counts_opt}, differing {differ[:5]}")
        del trainer, codec, disc, saved, restored, expected
        gc.collect()
        torch.cuda.empty_cache()

        counts_2, peak_2, out_2 = run(CODEC_RESUME_STEPS)
        if f"resumed GAN training from step {CODEC_TRAIN_STEPS}" not in out_2:
            fail("the second run_codec did not resume from the checkpoint")
        final = torch.load(out_dir / f"checkpoint_{CODEC_RESUME_STEPS}" / "state.pt",
                           map_location="cpu", weights_only=True)
        final_counts = (final["gen_optimizer"]["count"], final["disc_optimizer"]["count"])
        del final
        records = [json.loads(line) for line in open(out_dir / "metrics.jsonl")]
        steps = [r for r in records if "train/loss" in r]
        evals = [r for r in records if "eval/mel_loss" in r]
        names = ("loss", "mel/loss", "adv/gen_loss", "adv/feat_loss", "vq/commitment_loss",
                 "vq/codebook_loss", "adv/disc_loss")
        phases = ("g_forward", "d_step", "d_optim", "g_step", "g_optim")
        for r in steps:
            print(f"train (k) step {r['step']}: " + " ".join(
                f"{k} {r['train/' + k]:.5g}" for k in names) + "; seconds " + " ".join(
                f"{p} {r['train/time/' + p]:.4f}" for p in phases)
                + f" wall {1.0 / r['train/steps_per_sec']:.4f}", flush=True)
        walls = [1.0 / r["train/steps_per_sec"] for r in steps]
        timed = [r for i, r in enumerate(steps) if i not in (0, CODEC_TRAIN_STEPS)]  # warm-ups
        med = statistics.median(1.0 / r["train/steps_per_sec"] for r in timed)
        split = {p: statistics.median(r[f"train/time/{p}"] for r in timed) for p in phases}
        print(f"train (k) G+D step of B{batch} x {raw['training_segment_length']} s (f32, TF32 "
              f"off): median {med:.4f} s of wall after each run's first step ({batch / med:.2f} "
              f"segments per s); device time per phase (median) "
              f"{ {p: round(v, 4) for p, v in split.items()} }: D step {split['d_step']:.4f} s, G "
              f"step {split['g_forward'] + split['g_step']:.4f} s (forward "
              f"{split['g_forward']:.4f} + losses and backward {split['g_step']:.4f}), optimizers "
              f"{split['d_optim'] + split['g_optim']:.4f} s; peak device memory "
              f"{peak_1 / 2 ** 30:.2f} / {peak_2 / 2 ** 30:.2f} GiB (the two runs, "
              f"max_memory_allocated); eval mel loss {[e['eval/mel_loss'] for e in evals]}; "
              f"walls {[round(w, 4) for w in walls]} ({smi})", flush=True)
        want = no_launches()
        print(f"train (k) launches {counts_1} and {counts_2} expected {want}; final optimizer "
              f"counts {final_counts}", flush=True)
        values = [r[f"train/{k}"] for r in steps for k in names] + [e["eval/mel_loss"] for e in evals]
        if [r["step"] for r in steps] != list(range(1, CODEC_RESUME_STEPS + 1)) or len(evals) != 1 \
                or not all(map(math.isfinite, values)):
            fail(f"codec training: steps {[r['step'] for r in steps]}, evals {evals}, "
                 f"non-finite values in {values}")
        if counts_1 != want or counts_2 != want:
            fail(f"codec training at f32 launched kernels: {counts_1}, {counts_2}")
        if final_counts != (CODEC_RESUME_STEPS,) * 2:
            fail(f"the resumed run's optimizer counts {final_counts}")

        # the best generator, exported in the reference format, in bf16
        codec = hub.load_codec(str(out_dir / "best_model"), device=dev, dtype=torch.bfloat16)
        clip = torch.from_numpy(prompt_wav(CODEC_CLIP_SECONDS, SEED + 160, 16000)).to(dev)
        x = clip.float()[None, :, None]
        length = x.shape[1]
        reset_launches()
        out = codec(x)
        torch.cuda.synchronize()
        counts_rt = all_launches()
        shapes_rt = set(resunit_shapes)
        n_units = 3 * (len(codec.config.encoder_rates) + len(codec.config.decoder_rates))
        fused = sum(1 for m in codec.decoder.modules() if isinstance(m, DecoderBlock) and m.fused)
        want_rt = no_launches(resunit=n_units, decoder_block=fused)
        with plain_versions(ops):
            plain = codec(x)
            plain_audio = codec.decode(out["z"], length)
        rel_z = rel_l2(torch, out["z_e"], plain["z_e"])
        rel_audio = rel_l2(torch, out["audio"], plain_audio)
        same = (out["codes"][:, 0] == plain["codes"][:, 0]).float().mean().item()
        print(f"train (k) export: bf16 round trip of a seeded {CODEC_CLIP_SECONDS:.0f} s clip: "
              f"audio {tuple(out['audio'].shape)} finite {bool(torch.isfinite(out['audio']).all())}; "
              f"against the plain versions: encoder latents rel_l2 {rel_z:.4g} (tol "
              f"{TOKENIZE_REL_L2_TOL}), level-0 codes equal {same:.4f} (min "
              f"{TOKENIZE_ACOUSTIC_SAME}), decode of the same z rel_l2 {rel_audio:.4g} (tol "
              f"{DECODE_REL_L2_TOL}); launches {counts_rt} expected {want_rt}", flush=True)
        if (tuple(out["audio"].shape) != (1, length, 1) or not torch.isfinite(out["audio"]).all()
                or counts_rt != want_rt):
            fail(f"the exported codec's round trip: {tuple(out['audio'].shape)}, {counts_rt}")
        if not (rel_z <= TOKENIZE_REL_L2_TOL and rel_audio <= DECODE_REL_L2_TOL
                and same >= TOKENIZE_ACOUSTIC_SAME):
            fail(f"the round trip against the plain versions: {rel_z}, {rel_audio}, {same}")

        # K1/K2 under autograd: a loss on the encoder latents of the clip and
        # on the decode of the round trip's z, the model's kernel-run tensors
        # (every residual unit; the K2 blocks' snake and transposed conv);
        # against the plain versions, and each tensor against the same
        # model's f32 gradient (plain compositions, no kernel)
        c32 = copy.deepcopy(codec)
        c32.encoder.float()
        c32.decoder.float()
        c32.dtype = torch.float32
        c32.pack()
        z = out["z"].detach()
        gen = torch.Generator(device=dev).manual_seed(SEED + 161)
        w_z = torch.randn(out["z_e"].shape, generator=gen, device=dev)
        w_a = torch.randn(out["audio"].shape, generator=gen, device=dev)

        def gradients(model) -> dict:
            checked = {f"{name}.{p_name}": p
                       for name, m in model.named_modules()
                       if isinstance(m, ResidualUnit) or (isinstance(m, DecoderBlock) and m.fused)
                       for p_name, p in (m.named_parameters() if isinstance(m, ResidualUnit)
                                         else m.block[:2].named_parameters())}
            model.zero_grad(set_to_none=True)
            xg = x.clone().requires_grad_()
            with torch.enable_grad():
                loss = ((model.encoder(xg).float() * w_z).sum()
                        + (model.decode(z, length).float() * w_a).sum())
                loss.backward()
            torch.cuda.synchronize()
            return {"x": xg.grad.float(), **{n: p.grad.float().clone() for n, p in checked.items()}}

        def flat(grads) -> torch.Tensor:
            return torch.cat([g.flatten() for g in grads.values()])

        reset_launches()
        with_kernels = gradients(codec)
        counts_grad = all_launches()
        shapes_grad = set(resunit_shapes)
        with plain_versions(ops):
            reference = gradients(codec)
        exact = gradients(c32)

        def judge(grads) -> tuple[float, dict, str]:
            """(flattened rel l2 to the plain versions, per-tensor distances
            to f32 over their limits, the worst tensor)"""
            over = {n: rel_l2(torch, grads[n], exact[n]) / (
                CODEC_GRAD_NOISE_FACTOR * rel_l2(torch, reference[n], exact[n])
                + CODEC_GRAD_NOISE_FLOOR) for n in exact}
            return rel_l2(torch, flat(grads), flat(reference)), over, max(over, key=over.get)

        rels = {n: rel_l2(torch, with_kernels[n], reference[n]) for n in reference}
        worst = max(rels, key=rels.get)
        flat_rel, over, worst_over = judge(with_kernels)
        plain_f32 = {n: rel_l2(torch, reference[n], exact[n]) for n in exact}
        kernel_f32 = {n: rel_l2(torch, with_kernels[n], exact[n]) for n in exact}
        print(f"train (k) K1/K2 gradient: {len(rels)} tensors (x and the alphas, v, g and "
              f"biases of {n_units} units and {fused} K2 blocks); against the plain versions: "
              f"flattened relative l2 {flat_rel:.4g} (tol {CODEC_GRAD_REL_L2_TOL}), per tensor "
              f"largest {rels[worst]:.4g} at {worst}, median {statistics.median(rels.values()):.4g}, "
              f"x {rels['x']:.4g}; against the f32 model's gradient: kernels largest "
              f"{max(kernel_f32.values()):.4g} median {statistics.median(kernel_f32.values()):.4g} "
              f"flattened {rel_l2(torch, flat(with_kernels), flat(exact)):.4g}, the plain bf16 "
              f"composition largest {max(plain_f32.values()):.4g} median "
              f"{statistics.median(plain_f32.values()):.4g} flattened "
              f"{rel_l2(torch, flat(reference), flat(exact)):.4g}; the kernels' distance over its "
              f"limit ({CODEC_GRAD_NOISE_FACTOR} x the plain composition's + "
              f"{CODEC_GRAD_NOISE_FLOOR}) at most {over[worst_over]:.4g} at {worst_over}; launches "
              f"{counts_grad} expected {want_rt} ({smi})", flush=True)

        # a planted fault: K1's backward recomputing its unit with alpha2 = 1
        import edm_tts_tpu_torch.ops.decoder_block as block_ops
        import edm_tts_tpu_torch.ops.resunit as resunit_ops

        original = resunit_ops.resunit_reference

        def faulty(x, a1, w7, b7, a2, w1, b1, *, dilation):
            return original(x, a1, w7, b7, a2 * 0 + 1, w1, b1, dilation=dilation)

        resunit_ops.resunit_reference = block_ops.resunit_reference = faulty
        try:
            fault_flat, fault_over, fault_worst = judge(gradients(codec))
        finally:
            resunit_ops.resunit_reference = block_ops.resunit_reference = original
        print(f"train (k) K1/K2 gradient, planted fault (K1's backward with alpha2 = 1): "
              f"flattened {fault_flat:.4g}, over its limit at most {fault_over[fault_worst]:.4g} "
              f"at {fault_worst}", flush=True)
        if counts_grad != want_rt or not flat_rel <= CODEC_GRAD_REL_L2_TOL or \
                not over[worst_over] <= 1.0:
            fail(f"K1/K2 gradients: flattened {flat_rel}, {worst_over} at {over[worst_over]} of "
                 f"its limit, launches {counts_grad}")
        if fault_flat <= CODEC_GRAD_REL_L2_TOL and fault_over[fault_worst] <= 1.0:
            fail("the K1/K2 gradient limits let a wrong backward pass")
        missing = (shapes_rt | shapes_grad) - held_k1
        if missing:
            fail(f"(k) ran K1 at shapes the kernel phase did not hold: {sorted(missing)}")
        del codec, c32, out, plain, with_kernels, reference, exact
        gc.collect()
        torch.cuda.empty_cache()
        return {name: counts_rt[name] + counts_grad[name] for name in KERNELS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def conformer_api_check(torch, t2s, dev) -> dict:
    """The Conformer API on the full-width bf16 t2s (``extract_features``):
    with ``output_layer_idx=API_LAYER`` exactly API_LAYER + 1 K3 launches and
    the output of block API_LAYER of a full forward (to the bit); with
    ``return_attn`` no kernel launch, one f32 ``(B, H, T, T)`` map per block
    whose rows sum to 1 and give masked keys no weight, and the final hidden
    state within REL_L2_TOL of the kernels' forward. Returns the launches of
    the early exit."""
    from edm_tts_tpu_torch.kernels import all_launches, reset_launches

    cfg = t2s.cfg
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    ids = torch.randint(1, cfg.total_num_tokens, (2, API_CANVAS), generator=gen, device=dev)
    valid = torch.tensor([[API_CANVAS - API_PAD], [API_CANVAS]], device=dev)
    mask = torch.arange(API_CANVAS, device=dev)[None] < valid
    ids = torch.where(mask, ids, 0)

    def counted(**kw):
        reset_launches()
        out = t2s.extract_features(ids, mask, **kw)
        torch.cuda.synchronize()
        return out, all_launches()

    block_out = {}
    hook = t2s.conformer.layers[API_LAYER].register_forward_hook(
        lambda module, args, out: block_out.setdefault("x", out.clone()))
    try:
        full, counts_full = counted()
    finally:
        hook.remove()
    early, counts_early = counted(output_layer_idx=API_LAYER)
    (plain, maps), counts_attn = counted(return_attn=True)
    depth = cfg.main_encoder_num_layers
    heads = cfg.main_encoder_num_heads
    shapes_ok = len(maps) == depth and all(
        m.dtype == torch.float32 and tuple(m.shape) == (2, heads, API_CANVAS, API_CANVAS)
        for m in maps)
    row_err = max((m.sum(-1) - 1).abs().max().item() for m in maps)
    masked_weight = max(m[0, :, :, API_CANVAS - API_PAD:].abs().max().item() for m in maps)
    rel = rel_l2(torch, plain, full)
    same = torch.equal(early, block_out["x"])
    print(f"api: t2s extract_features (bf16, B2 x {API_CANVAS}, row 0 with {API_PAD} keys "
          f"masked): full forward launches {counts_full}; output_layer_idx={API_LAYER} "
          f"launches {counts_early}, equal to block {API_LAYER}'s output of the full forward: "
          f"{same}; return_attn launches {counts_attn}, {len(maps)} maps of "
          f"{tuple(maps[0].shape)} {maps[0].dtype}, largest |row sum - 1| {row_err:.3g} (tol "
          f"{API_ROW_SUM_TOL}), largest weight on a masked key {masked_weight:.3g}, final hidden "
          f"state against the kernels' relative l2 {rel:.4g} (tol {REL_L2_TOL})", flush=True)
    if (counts_full != no_launches(attention=depth)
            or counts_early != no_launches(attention=API_LAYER + 1)
            or counts_attn != no_launches()):
        fail(f"api: launches {counts_full}, {counts_early}, {counts_attn}")
    if not (same and shapes_ok and row_err <= API_ROW_SUM_TOL and masked_weight == 0.0
            and rel <= REL_L2_TOL):
        fail(f"api: early exit equal {same}, maps {shapes_ok}, row sums {row_err}, masked "
             f"weight {masked_weight}, hidden state {rel}")
    return counts_early


def closed_loop_path(torch, dev, smi: str) -> dict:
    """(l): the closed-loop rehearsal at full width (see LOOP_*). Builds the
    recipes (the codec's CODEC_RECIPE, the t2s's and s2a's of
    profile_synthesis, each cut as printed) and a seeded f32 HuBERT-large,
    and runs ``closed_loop.run`` in a fresh temporary root: the seven stages
    through the port's CLIs on the card, the JAX script's final check on the
    f32 wav; then a bf16 ``--quantize int8 --one_shot`` inference on the same
    directories. Checks each stage's kernel launches exactly (the f32 stages
    only K3-f32, with K4-f32 in the trainers; the bf16 run K1, K2, K3 and
    K5 as a request of (c) makes them, plus the prompt's tokenization), the
    codec export (12 codebooks), the centroids, every shard's ranges, both
    exports, every logged loss finite and the bf16 wav. Returns the
    launches of all its runs."""
    import tempfile

    import numpy as np

    from edm_tts_tpu_torch import closed_loop
    from edm_tts_tpu_torch.data.manifests import librispeech_manifest
    from edm_tts_tpu_torch.data.pipeline import load_audio_segments
    from edm_tts_tpu_torch.data.token_shards import iter_token_shards
    from edm_tts_tpu_torch.models.codec.decoder import DecoderBlock
    from edm_tts_tpu_torch.profile_synthesis import (
        PRED_ITERS,
        STEPS,
        s2a_train_recipe,
        t2s_train_recipe,
    )
    from edm_tts_tpu_torch.profile_tokenization import full_width_semantic
    from edm_tts_tpu_torch.utils import hub

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_loop_"))
    try:
        t_all = time.perf_counter()
        loop = str(tmp / "loop")
        codec_recipe = dict(
            CODEC_RECIPE, output_dir=f"{loop}/codec", logging_steps=1,
            max_steps=LOOP_CODEC_STEPS, eval_steps=LOOP_CODEC_STEPS, save_steps=LOOP_CODEC_STEPS,
            validation_segment_length=LOOP_SEGMENT_SECONDS,
            dataset_args={"path": "librispeech", "name": "train-clean-100",
                          "data_dir": f"{loop}/data"})
        t2s_recipe = dict(t2s_train_recipe(f"{loop}/t2s", f"{loop}/codes", SEED, LOOP_STEPS),
                          bf16=False)
        s2a_recipe = dict(s2a_train_recipe(f"{loop}/s2a", f"{loop}/codes", SEED, LOOP_STEPS),
                          bf16=False, training_segment_length=LOOP_SEGMENT_SECONDS,
                          acoustic_model_path=f"{loop}/codec/best_model")
        if not (t2s_recipe["extra_model_params"]["semantic_vocab_size"] == LOOP_K
                == s2a_recipe["extra_model_params"]["num_semantic_tokens"]):
            fail("(l): the recipes' semantic vocabulary is not LOOP_K")
        print(f"loop (l): cuts: codec max_steps {CODEC_RECIPE['max_steps']} -> "
              f"{LOOP_CODEC_STEPS} (eval and save at {LOOP_CODEC_STEPS}, from "
              f"{CODEC_RECIPE['eval_steps']} and {CODEC_RECIPE['save_steps']}), "
              f"validation_segment_length {CODEC_RECIPE['validation_segment_length']} -> "
              f"{LOOP_SEGMENT_SECONDS} s; hubert_kmeans frames_per_cluster 1000 -> "
              f"{LOOP_FRAMES_PER_CLUSTER}, nredo 5 -> {closed_loop.NREDO}; t2s and s2a {LOOP_STEPS} "
              f"steps with a 2-step warmup at f32 (bf16: false), s2a training_segment_length "
              f"15.36 -> {LOOP_SEGMENT_SECONDS} s; data {LOOP_SPEAKERS} speakers x {LOOP_UTTS} "
              f"utterances of 3.2-4 s", flush=True)
        hubert = full_width_semantic(dev, SEED + 170, dtype=torch.float32)
        depth, hubert_cfg = hubert.output_layer, hubert.config
        try:
            result = closed_loop.run(
                loop, codec_recipe=codec_recipe, t2s_recipe=t2s_recipe, s2a_recipe=s2a_recipe,
                hubert=hubert, k=LOOP_K, frames_per_cluster=LOOP_FRAMES_PER_CLUSTER,
                device="cuda", n_speakers=LOOP_SPEAKERS, n_utts=LOOP_UTTS,
                pred_iters=PRED_ITERS, s2a_steps=STEPS)
        except (SystemExit, AssertionError) as e:
            fail(f"(l) the closed loop failed: {e}")
        del hubert
        gc.collect()
        torch.cuda.empty_cache()

        # the bf16 int8 run on the same three directories
        prompt = f"{loop}/data/LibriSpeech/train-clean-100/100/1/100-1-0000.flac"
        bf16_wav = f"{loop}/out_bf16_int8.wav"
        try:
            bf16_run = closed_loop.run_stage("7_inference_bf16_int8", [
                sys.executable, "-m", "edm_tts_tpu_torch.inference", "-s", prompt,
                "-t", closed_loop.TEXT, "-o", bf16_wav,
                "--codec_model", f"{loop}/codec/best_model", "--t2s_model", f"{loop}/t2s/export",
                "--s2a_model", f"{loop}/s2a/export", "--hubert_model", f"{loop}/hubert_semantic",
                "--max_speech_len", str(closed_loop.MAX_SPEECH_LEN),
                "--gt_length", str(closed_loop.GT_LENGTH),
                "--dtype", "bfloat16", "--quantize", "int8", "--one_shot"], loop)
            bf16_check = closed_loop.check_wav(bf16_wav, closed_loop.GT_LENGTH)
        except (SystemExit, AssertionError) as e:
            fail(f"(l) the bf16 int8 inference: {e}")

        # the artifacts
        codec = hub.load_codec(f"{loop}/codec/best_model", device=dev)
        codec_bf16 = hub.load_codec(f"{loop}/codec/best_model", device=dev, dtype=torch.bfloat16)
        fused = sum(1 for m in codec_bf16.decoder.modules()
                    if isinstance(m, DecoderBlock) and m.fused)
        levels, codebook = codec.config.n_codebooks, codec.config.codebook_size
        encoder_units = 3 * len(codec.config.encoder_rates)
        centers = np.load(hub.find_centroids(f"{loop}/hubert_semantic"))
        items = list(iter_token_shards(f"{loop}/codes"))
        bad = [it["id"] for it in items
               if it["acoustic_tokens"].shape != (levels, it["semantic_tokens"].shape[0])
               or not 0 <= it["acoustic_tokens"].min() <= it["acoustic_tokens"].max() < codebook
               or not 0 <= it["semantic_tokens"].min() <= it["semantic_tokens"].max() < LOOP_K]
        t2s = hub.load_t2s(f"{loop}/t2s/export", device=dev)
        s2a = hub.load_s2a(f"{loop}/s2a/export", device=dev)
        t2s_cfg, s2a_cfg = t2s.cfg, s2a.cfg
        del codec, codec_bf16, t2s, s2a
        gc.collect()
        torch.cuda.empty_cache()
        logged = {d: [json.loads(line) for line in open(f"{loop}/{d}/metrics.jsonl")]
                  for d in ("codec", "t2s", "s2a")}
        steps = {d: [r["step"] for r in rs if "train/loss" in r] for d, rs in logged.items()}
        losses = [v for rs in logged.values() for r in rs for k, v in r.items() if "loss" in k]
        for d, rs in logged.items():
            train = [r["train/loss"] for r in rs if "train/loss" in r]
            evals = [v for r in rs for k, v in r.items() if k.startswith("eval/")]
            print(f"loop (l) {d} training: train/loss {train}; eval {evals}", flush=True)
        print(f"loop (l) artifacts: best_model {levels} codebooks of {codebook}; centroids "
              f"{centers.shape} finite {bool(np.isfinite(centers).all())}; {len(items)} dumped "
              f"items, out of range: {bad}; exports t2s (vocab {t2s_cfg.semantic_vocab_size}) "
              f"and s2a ({s2a_cfg.num_semantic_tokens} semantic tokens, a codec of "
              f"{s2a_cfg.codec.n_codebooks} codebooks); steps logged {steps}; "
              f"{len(losses)} losses, all finite {all(map(math.isfinite, losses))}; f32 wav "
              f"{result['wav']}, bf16 int8 wav {bf16_check}", flush=True)
        if (levels != CODEC_RECIPE["generator_args"]["n_codebooks"]
                or centers.shape != (LOOP_K, hubert_cfg.hidden_size)
                or not np.isfinite(centers).all()
                or len(items) != LOOP_SPEAKERS * LOOP_UTTS or bad
                or steps != {"codec": list(range(1, LOOP_CODEC_STEPS + 1)),
                             "t2s": list(range(1, LOOP_STEPS + 1)),
                             "s2a": list(range(1, LOOP_STEPS + 1))}
                or not all(map(math.isfinite, losses))):
            fail("(l): an artifact of the loop is malformed (above)")

        # each stage's launches
        target = LOOP_K * LOOP_FRAMES_PER_CLUSTER
        frames = used = 0
        for ex in librispeech_manifest(f"{loop}/data", "train-clean-100"):
            samples = min(len(next(load_audio_segments(ex, 16000, None))["audio"]), 30 * 16000)
            frames += int(hubert_cfg.feature_lengths(samples))
            used += 1
            if frames >= target:
                break
        t2s_depth = t2s_cfg.main_encoder_num_layers + t2s_cfg.length_predictor_num_layers
        s2a_passes = s2a_recipe["micro_batches"] * LOOP_STEPS * s2a_cfg.encoder_num_layers
        request = int8_request_launches(t2s_cfg, s2a_cfg, True, PRED_ITERS, STEPS)
        want = {
            "codec_gan_training": no_launches(),
            "hubert_kmeans": no_launches(attention_f32=depth * used),
            "dump_tokens": no_launches(attention_f32=depth * -(-len(items) // 4)),
            "t2s_training": no_launches(attention_f32=t2s_depth * LOOP_STEPS,
                                        attention_bwd_f32=t2s_depth * LOOP_STEPS),
            "s2a_training": no_launches(attention_f32=s2a_passes, attention_bwd_f32=s2a_passes),
            "inference": no_launches(attention_f32=depth + request["attention"]),
            "inference_bf16_int8": no_launches(
                resunit=encoder_units + request["resunit"], decoder_block=fused,
                attention=depth + request["attention"], int8_dense=request["int8_dense"]),
        }
        runs = {**{k: result[k] for k in want if k in result}, "inference_bf16_int8": bf16_run}
        for name, r in runs.items():
            with open(r["log"]) as f:
                tail = [line.rstrip() for line in f if not line.startswith("kernel launches")]
            print(f"loop (l) {name}: {r['seconds']:.2f} s; launches {r['launches']} expected "
                  f"{want[name]} ({smi}); its log's last lines:\n  " + "\n  ".join(tail[-4:]),
                  flush=True)
        wrong = [name for name, r in runs.items() if r["launches"] != want[name]]
        total = time.perf_counter() - t_all
        print(f"loop (l): the seven stages in {result['seconds']:.2f} s (stage 0, the data and "
              f"HuBERT-large written, {result['setup_seconds']:.2f} s), the bf16 int8 run "
              f"{bf16_run['seconds']:.2f} s, the path {total:.2f} s with its checks ({smi})",
              flush=True)
        if wrong:
            fail(f"(l): the launches of {wrong} differ from the expected (above)")
        return {name: sum(r["launches"][name] for r in runs.values()) for name in KERNELS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


DP_STEPS = 3  # path (m): the one-rank torchrun run's ZeRO-2 steps
DP_TIMEOUT_S = 420
# path (m)'s first DP step against the plain Trainer's: the loss to a
# relative DP_LOSS_REL_TOL, the parameters to PARAM_TOL of
# tests/test_torch_s2a_train.py (atol and rtol 1e-6)
DP_LOSS_REL_TOL = 1e-6
DP_PARAM_ATOL = DP_PARAM_RTOL = 1e-6
# path (m)'s engine replicas: equal to the bit to replica_witness, and to
# one engine but for bf16 with float weights, whose share of audio samples
# within REPLICA_SAMPLE_TOL of the largest magnitude is printed
REPLICA_SAMPLE_TOL = 2.0 ** -5
REPLICA_GT = (500, 400)


def dp_step_worker(out_dir: str) -> int:
    """Path (m)'s process under ``torchrun --nproc_per_node 1``: one NCCL
    rank. The s2a recipe of (d) at full width (B32 x 768, bf16, 4
    micro-batches): one step of the one-process ``Trainer`` (``local_mesh``)
    from the seeded init, then the same init through the data-parallel
    ``Trainer`` (ZeRO-2 ``AdamW`` over the NCCL group: its reduce-scatter
    and all-gather on the card) for DP_STEPS steps, the first on the same batch. Writes what it
    measured to ``out_dir/dp.json``; exits 1 when a check fails."""
    import torch

    from edm_tts_tpu_torch.kernels import all_launches, build, reset_launches
    from edm_tts_tpu_torch.parallel import dist as pdist
    from edm_tts_tpu_torch.parallel.mesh import local_mesh
    from edm_tts_tpu_torch.profile_synthesis import s2a_train_recipe
    from edm_tts_tpu_torch.train import run_s2a
    from edm_tts_tpu_torch.train.trainer import Trainer

    dev = pdist.initialize("cuda")
    backend = torch.distributed.get_backend()
    build.library()
    raw = s2a_train_recipe(os.path.join(out_dir, "dp"), os.path.join(out_dir, "shards"), SEED,
                           DP_STEPS)
    model = run_s2a.build_model(raw, dev)
    cfg = model.cfg
    frames = int(raw["training_segment_length"] * cfg.codec.sample_rate / cfg.codec.hop_length)
    batches = list(itertools.islice(run_s2a.code_batch_iterator(
        os.path.join(out_dir, "shards"), frames, raw["per_device_train_batch_size"], SEED),
        DP_STEPS))
    _, loss_fn = run_s2a.s2a_loss(model, bf16=True)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    plain = Trainer(run_s2a.training_arguments({**raw, "output_dir": os.path.join(
        out_dir, "plain")}), model, loss_fn, device=dev, mesh=local_mesh())
    plain_loss = plain.train_step(batches[0], 0)["loss"].item()
    plain_params = {n: p.detach().clone() for n, p in plain.optimizer.named}
    del plain
    model.load_state_dict(initial)
    del initial
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(run_s2a.training_arguments(raw), model, loss_fn, device=dev)
    out = {"backend": backend, "world": trainer.mesh.world, "mesh": trainer.mesh.shape,
           "sharded": trainer.optimizer.fsdp is not None, "plain_loss": plain_loss,
           "moments": trainer.optimizer.mu.numel(),
           "step_s": [], "losses": [], "counts": []}
    for i, batch in enumerate(batches):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, i)
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["counts"].append(all_launches())
        out["losses"].append(metrics["loss"].item())
        if i == 0:
            errs = {n: (p.detach() - plain_params[n]).abs().max().item()
                    for n, p in trainer.optimizer.named}
            out["param_max_abs_err"] = max(errs.values())
            out["params_within_tol"] = all(bool(((p.detach() - plain_params[n]).abs() <= (
                DP_PARAM_ATOL + DP_PARAM_RTOL * plain_params[n].abs())).all())
                for n, p in trainer.optimizer.named)
            del plain_params
            # the first step's peak holds the comparison's copy of the
            # parameters; the later steps' is the data-parallel step's own
            out["peak_first_bytes"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    with open(os.path.join(out_dir, "dp.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


def replica_witness(torch, engine, texts, speaker: str, seed: int, gt_lengths,
                    parts: int) -> list:
    """What ``parts`` replicas of ``engine`` must give, without its replica
    code: on the engine's own models, one part after another, each part's
    rows through ``t2s_sample`` and ``s2a_sample`` with the request's seed
    and the part's first row as ``row_offset``, the s2a canvas from every
    row, then the codec's decode (the engine's synthesis, written out)."""
    from edm_tts_tpu_torch.models.s2a import s2a_sample
    from edm_tts_tpu_torch.models.t2s import t2s_sample
    from edm_tts_tpu_torch.utils.bucketing import bucket_length

    dev = engine.device
    seqs = [[c + 5 for c in t.encode("utf-8")] for t in texts]
    width = bucket_length(max(len(q) for q in seqs), engine.text_bucket)
    tokens = torch.tensor([q + [0] * (width - len(q)) for q in seqs], device=dev)
    lengths = torch.tensor([len(q) for q in seqs], device=dev)
    gt = torch.tensor(list(gt_lengths), device=dev)
    rows = len(texts) // parts
    prompt = engine.prompt(speaker)
    stage1, audio = [], []
    with torch.no_grad():
        for i in range(parts):
            part = slice(i * rows, (i + 1) * rows)
            generator = torch.Generator().manual_seed(seed)
            stage1.append((t2s_sample(
                engine.t2s, tokens[part], lengths[part], generator,
                pred_iters=engine.pred_iters, temperature=engine.temperature,
                max_speech_len=engine.max_speech_len, gt_length=gt[part],
                row_offset=i * rows), generator))
        n_max = bucket_length(int(max(out["lengths"].max() for out, _ in stage1)),
                              engine.length_bucket, engine.max_speech_len)
        pa, ps = prompt.acoustic_codes, prompt.semantic_codes
        for i, (out, generator) in enumerate(stage1):
            valid = torch.arange(n_max, device=dev)[None, :] < out["lengths"][:, None]
            codes = s2a_sample(
                engine.s2a, out["semantic_tokens"][:, :n_max], pa.expand(rows, *pa.shape[1:]),
                ps.expand(rows, *ps.shape[1:]), generator, steps=engine.s2a_steps,
                temperature=engine.temperature, semantic_valid=valid, row_offset=i * rows)
            wav = engine.s2a.acoustic_model.decode_from_codes(codes, out["lengths"])
            wav = wav[..., 0].float().cpu().numpy()
            audio += [w[:int(n) * engine.hop_length] for w, n in zip(wav, out["lengths"].cpu())]
    return audio


def multi_device_path(torch, dev, smi: str) -> dict:
    """(m): the multi-device layer on one card. A ``torchrun
    --nproc_per_node 1`` subprocess (``dp_step_worker``: the data-parallel
    ZeRO-2 s2a step on one NCCL rank, held against the one-process step);
    then two engine replicas on this card (bf16 and int8, bucket 2) against
    one engine. The ring's kernel steps are phase 3's ring cases."""
    import copy
    import tempfile

    import numpy as np

    from edm_tts_tpu_torch.kernels import all_launches, reset_launches
    from edm_tts_tpu_torch.profile_synthesis import (
        GEN_FRAMES,
        PRED_ITERS,
        STEPS,
        bench_inputs,
        full_width_models,
    )
    from edm_tts_tpu_torch.serving.engine import TTSEngine

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        write_s2a_shards(os.path.join(tmp, "shards"))
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
               "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
               os.path.abspath(__file__), "--dp-step", tmp]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=DP_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"multi-device (m): torchrun exited {proc.returncode}:\n{proc.stdout[-3000:]}"
                 f"\n{proc.stderr[-3000:]}")
        with open(os.path.join(tmp, "dp.json")) as f:
            dp = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    depth = 16
    want = no_launches(attention=4 * depth, attention_bwd=4 * depth)
    med = statistics.median(dp["step_s"][1:])
    print(f"multi-device (m) torchrun --nproc_per_node 1: backend {dp['backend']}, world "
          f"{dp['world']}, mesh {dp['mesh']}, fsdp collectives {dp['sharded']} ({dp['moments']} "
          f"moments a rank); {len(dp['step_s'])} steps of B32 x 768 (4 micro-batches) step "
          f"seconds {[round(x, 4) for x in dp['step_s']]} (median after the first {med:.4f} s), "
          f"losses {[round(x, 5) for x in dp['losses']]}, peak device memory "
          f"{dp['peak_bytes'] / 2 ** 30:.2f} GiB in the steps after the first (the first "
          f"{dp['peak_first_bytes'] / 2 ** 30:.2f} GiB with the comparison's copy of the "
          f"parameters), launches per step {dp['counts']} expected "
          f"{want}; first step against the one-process Trainer: loss {dp['losses'][0]:.7f} vs "
          f"{dp['plain_loss']:.7f} (rel tol {DP_LOSS_REL_TOL}), parameters max abs err "
          f"{dp['param_max_abs_err']:.3g} (atol/rtol {DP_PARAM_ATOL}); subprocess wall "
          f"{wall:.1f} s ({smi})", flush=True)
    if dp["backend"] != "nccl" or dp["world"] != 1 or not dp["sharded"]:
        fail(f"multi-device (m): backend {dp['backend']}, world {dp['world']}, sharded "
             f"{dp['sharded']}")
    if any(c != want for c in dp["counts"]):
        fail(f"multi-device (m): launches per step {dp['counts']} != {want}")
    if not (abs(dp["losses"][0] - dp["plain_loss"]) <= DP_LOSS_REL_TOL * abs(dp["plain_loss"])
            and dp["params_within_tol"] and all(np.isfinite(dp["losses"]))):
        fail("multi-device (m): the data-parallel step differs from the one-process step")
    counts = {k: sum(c[k] for c in dp["counts"]) for k in want}

    # two replicas of the full-width models on this card against one engine,
    # in bf16 and f32, each with float and int8 weights
    texts = ["The first of two rows of a bucket.", "And the second row, a little shorter."]
    opts = dict(device=dev, pred_iters=PRED_ITERS, s2a_steps=STEPS, max_speech_len=GEN_FRAMES,
                batch_buckets=(2,))
    for dtype, quantize in itertools.product((torch.bfloat16, torch.float32), ("none", "int8")):
        t2s, s2a = full_width_models(dev, SEED, dtype)
        inp = bench_inputs(s2a.cfg, dev, SEED)
        outs, calls = [], []
        for mesh in (None, [dev, dev]):
            engine = TTSEngine.from_models(copy.deepcopy(t2s), copy.deepcopy(s2a),
                                           quantize=quantize, mesh=mesh, **opts)
            engine.register_speaker_codes("p", inp["prompt_ac"], inp["prompt_sem"])
            engine.synthesize(texts, "p", seed=SEED, gt_lengths=list(REPLICA_GT))  # warm-up
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(engine.synthesize(texts, "p", seed=SEED + 1, gt_lengths=list(REPLICA_GT)))
            torch.cuda.synchronize()
            calls.append((time.perf_counter() - t0, all_launches()))
        witness = replica_witness(torch, engine, texts, "p", SEED + 1, REPLICA_GT, 2)
        del engine, t2s, s2a
        gc.collect()
        torch.cuda.empty_cache()
        single, replicas = outs
        label = f"{str(dtype).split('.')[-1]} {quantize}"
        for a, b in zip(replicas, single):
            if a.shape != b.shape or not np.isfinite(a).all() or not np.abs(a).max() > 0:
                fail(f"multi-device (m) replicas {label}: audio {a.shape} vs {b.shape}, not "
                     "finite or silent")
        as_witness = all(np.array_equal(a, b) for a, b in zip(replicas, witness))
        as_single = all(np.array_equal(a, b) for a, b in zip(replicas, single))
        diffs = [float(np.abs(a - b).max()) for a, b in zip(replicas, single)]
        shares = [float((np.abs(a - b) <= REPLICA_SAMPLE_TOL * np.abs(b).max()).mean())
                  for a, b in zip(replicas, single)]
        # bf16 with float weights: one engine runs each product over both rows
        # at once, the replicas over one, and cuBLAS's bf16 products need not
        # round alike at the two sizes; the witness runs the replicas' sizes
        held_single = not (dtype == torch.bfloat16 and quantize == "none")
        print(f"multi-device (m) engine replicas {label}: two replicas on {dev}, bucket 2, "
              f"{[len(a) for a in replicas]} samples: equal to the witness {as_witness} "
              f"(held), equal to one engine {as_single} "
              f"({'held' if held_single else 'not held'}; max abs diff {diffs}, share within "
              f"{REPLICA_SAMPLE_TOL} of the peak {shares}); call seconds one engine "
              f"{calls[0][0]:.4f} replicas {calls[1][0]:.4f}; launches one engine "
              f"{calls[0][1]} replicas {calls[1][1]} ({smi})", flush=True)
        if not as_witness:
            fail(f"multi-device (m) replicas {label}: audio differs from the witness's")
        if held_single and not as_single:
            fail(f"multi-device (m) replicas {label}: audio differs from one engine's")
        if calls[1][1] != {k: 2 * v for k, v in calls[0][1].items()}:
            fail(f"multi-device (m) replicas {label}: launches {calls[1][1]} are not one "
                 f"engine's {calls[0][1]} on each of the two replicas")
    return counts


PIPE_BATCH = 8  # path (n): B8 x 768, (d)'s micro-batch, in PIPE_MICRO microbatches of 2
PIPE_MICRO = 4
PIPE_STAGES = (4, 1)  # local pipe meshes: all stages in this process
PIPE_REPEATS = 3  # timed steps of each, in turns
# the leaves whose gradient the pipe writes itself: the side inputs'
# projections and what feeds stage 0 (held one by one against forward_train)
PIPE_FRONT_LEAVES = ("encoder.project_injection.", "semantic_embedding.", "mask_token",
                     "acoustic_feat_proj.")
DRYRUN_TIMEOUT_S = 300


def pipe_attention_check(torch, model, loss, gen, smi: str) -> None:
    """K3 with its LSE and K4 on the q, k, v of the first and the last
    attention of one ``loss()`` forward (bf16 autocast, as path (n) runs it)
    against the plain versions: output and gradients within REL_L2_TOL and
    MAX_ABS_TOL of the largest value, the LSE within LSE_ABS_TOL. The
    gradient dO is drawn from ``gen``."""
    import edm_tts_tpu_torch.models.conformer.conformer as conformer_mod
    from edm_tts_tpu_torch import ops

    seen, true_mha = [], conformer_mod.mha

    def recording_mha(q, k, v, **kw):
        seen[1:] = [(q.clone(), k.clone(), v.clone())]
        return true_mha(q, k, v, **kw)

    conformer_mod.mha = recording_mha
    try:
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            loss()
    finally:
        conformer_mod.mha = true_mha
    if len(seen) != 2:
        fail(f"pipeline (n): {len(seen)} attentions recorded")
    for label, (q, k, v) in zip(("first", "last"), seen):
        g = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
        o, lse = ops.flash_mha(q, k, v, return_lse=True)
        lse_ref = ops.attention_lse_reference(q, k)
        held = {"attention": ((o,), (ops.mha_reference(q, k, v),)),
                "attention_bwd": (ops.flash_mha_bwd(q, k, v, None, o, lse, g),
                                  ops.flash_mha_bwd_reference(q, k, v, None, o, lse_ref, g))}
        errs = {name: (max(rel_l2(torch, a, r) for a, r in zip(outs, refs)),
                       max((a.float() - r.float()).abs().max().item()
                           / r.float().abs().max().item() for a, r in zip(outs, refs)))
                for name, (outs, refs) in held.items()}
        lse_err = (lse - lse_ref).abs().max().item()
        print(f"pipeline (n) K3 with LSE and K4 on the step's {label} attention "
              f"{tuple(q.shape)} {q.dtype}: (relative l2, max abs / largest) {errs} (tol "
              f"{REL_L2_TOL}, {MAX_ABS_TOL}), LSE max abs err {lse_err:.4g} (tol "
              f"{LSE_ABS_TOL}) ({smi})", flush=True)
        if not (all(r <= REL_L2_TOL and m <= MAX_ABS_TOL for r, m in errs.values())
                and lse_err <= LSE_ABS_TOL):
            fail(f"pipeline (n): K3 or K4 on the step's {label} attention differs from the "
                 f"plain version: {errs}, LSE {lse_err}")


def pipeline_path(torch, dev, smi: str) -> dict:
    """(n): GPipe on one card. The full-width s2a (d)'s seeded init, bf16
    autocast) on B8 x 768 in 4 microbatches through
    ``pipelined_train_loss`` on a local pipe of 4 stages and of 1 (all
    stages in this process; the hops are moves between the stages'
    buffers): loss and every gradient equal to the bit between the two, each
    within TRAIN_*_TOL of ``forward_train(..., mask_override=mask,
    train=False)`` on the whole batch, and 64 K3 and 64 K4 launches a step
    (16 blocks x 4 microbatches, no bubble ticks). Then ``python -m
    edm_tts_tpu_torch.dryrun_multichip`` under ``torchrun --nproc_per_node
    1`` (NCCL; leg 1 at one rank). Returns the launches of the pipe-4 step."""
    import tempfile

    import numpy as np

    from edm_tts_tpu_torch.kernels import all_launches, reset_launches
    from edm_tts_tpu_torch.models.s2a.pipeline import pipelined_train_loss
    from edm_tts_tpu_torch.ops import cosine_schedule_mask
    from edm_tts_tpu_torch.parallel.mesh import make_pipe_mesh
    from edm_tts_tpu_torch.profile_synthesis import s2a_train_recipe
    from edm_tts_tpu_torch.train import run_s2a

    tmp = tempfile.mkdtemp(prefix="chip_smoke_pipe_")
    try:
        raw = s2a_train_recipe(os.path.join(tmp, "out"), os.path.join(tmp, "shards"), SEED,
                               TRAIN_STEPS)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    model = run_s2a.build_model(raw, dev)
    cfg = model.cfg
    frames = int(raw["training_segment_length"] * cfg.codec.sample_rate / cfg.codec.hop_length)
    gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    ac = torch.randint(0, cfg.num_codevectors, (PIPE_BATCH, cfg.num_quantizers, frames),
                       generator=gen, device=dev)
    sem = torch.randint(0, cfg.num_semantic_tokens, (PIPE_BATCH, frames), generator=gen,
                        device=dev)
    mask = cosine_schedule_mask(gen, PIPE_BATCH, frames, device=dev)
    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]

    def step(loss_fn):
        """loss_fn's loss and every trainable gradient, the wall seconds and
        peak memory of the step, and its launches."""
        model.zero_grad(set_to_none=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.enable_grad():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                loss = loss_fn()
            loss.backward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = all_launches()
        grads = {n: p.grad for n, p in trainable}
        model.zero_grad(set_to_none=True)
        return loss.detach(), grads, wall, torch.cuda.max_memory_allocated(), counts

    def pipelined(stages):
        mesh = make_pipe_mesh(stages, local=True)
        return lambda: pipelined_train_loss(model, ac, sem, mask, mesh, n_micro=PIPE_MICRO)

    def device_ms(loss_fn):
        """One profiled step: the device's kernel milliseconds and kernels
        (the device's activity only: tracing the host's ops costs seconds)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(loss_fn)
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        return (sum(e.self_device_time_total for e in kernels) / 1e3,
                sum(e.count for e in kernels))

    def sequential():
        return model.forward_train(ac, sem, mask_override=mask, train=False)["loss"]

    depth = cfg.encoder_num_layers
    want = no_launches(attention=depth * PIPE_MICRO, attention_bwd=depth * PIPE_MICRO)
    step(pipelined(PIPE_STAGES[0]))  # warm-up
    # the stages in turns, PIPE_REPEATS times; each repeat equal to the bit to the first
    runs, walls, same = {}, {s: [] for s in PIPE_STAGES}, True
    for _ in range(PIPE_REPEATS):
        for s in PIPE_STAGES:
            run = step(pipelined(s))
            walls[s].append(run[2])
            if s in runs:
                same = same and torch.equal(run[0], runs[s][0]) and all(
                    torch.equal(run[1][n], runs[s][1][n]) for n, _ in trainable)
            else:
                runs[s] = run
    seq = step(sequential)
    seq_walls = [seq[2]] + [step(sequential)[2] for _ in range(PIPE_REPEATS - 1)]
    busy = {s: device_ms(pipelined(s)) for s in PIPE_STAGES}
    busy["sequential"] = device_ms(sequential)
    (l4, g4, _, peak4, counts), (l1, g1, _, peak1, counts1) = (runs[s] for s in PIPE_STAGES)
    wall4, wall1, seq_wall = (statistics.median(w) for w in (*walls.values(), seq_walls))
    bitwise = same and torch.equal(l4, l1) and all(torch.equal(g4[n], g1[n]) for n, _ in trainable)

    def flat(g):
        return torch.cat([g[n].float().flatten() for n, _ in trainable])

    seq_loss, seq_grad = seq[0].item(), flat(seq[1])
    gaps = {s: (abs(runs[s][0].item() - seq_loss) / abs(seq_loss),
                rel_l2(torch, flat(runs[s][1]), seq_grad)) for s in PIPE_STAGES}
    # each leaf's relative l2 too: the worst of all, and of the leaves whose
    # gradient the pipe writes itself (side inputs and the feed into stage 0)
    leaf = {s: {n: rel_l2(torch, runs[s][1][n].float(), seq[1][n].float())
                for n, _ in trainable} for s in PIPE_STAGES}
    front = [n for n, _ in trainable if n.startswith(PIPE_FRONT_LEAVES)]
    worst = {s: (max(leaf[s], key=leaf[s].get), max(front, key=leaf[s].get))
             for s in PIPE_STAGES}
    print(f"pipeline (n) s2a B{PIPE_BATCH} x {frames} in {PIPE_MICRO} microbatches, bf16: "
          f"pipe {PIPE_STAGES[0]} loss {l4.item():.7f} step {wall4:.4f} s (median of "
          f"{[round(w, 4) for w in walls[PIPE_STAGES[0]]]}) peak device memory "
          f"{peak4 / 2 ** 30:.2f} GiB launches {counts} expected {want}; pipe 1 loss "
          f"{l1.item():.7f} step {wall1:.4f} s (of "
          f"{[round(w, 4) for w in walls[PIPE_STAGES[1]]]}) peak {peak1 / 2 ** 30:.2f} GiB "
          f"launches {counts1}; equal to the bit {bitwise} (each "
          f"repeat too); sequential forward_train loss {seq_loss:.7f} step {seq_wall:.4f} s (of "
          f"{[round(w, 4) for w in seq_walls]}) peak {seq[3] / 2 ** 30:.2f} GiB; loss relative "
          f"gap / gradient relative l2 to it {gaps} (tol {TRAIN_LOSS_REL_TOL} / "
          f"{TRAIN_GRAD_REL_L2_TOL}); worst leaf's relative l2 (all / the pipe's own "
          f"{len(front)} leaves) "
          f"{ {s: [(n, round(leaf[s][n], 6)) for n in worst[s]] for s in PIPE_STAGES} } "
          f"(tol {TRAIN_GRAD_REL_L2_TOL} on the pipe's own); device kernel ms and kernels "
          f"of one profiled step "
          f"{busy}, busy share pipe {PIPE_STAGES[0]} {busy[PIPE_STAGES[0]][0] / 1e3 / wall4:.3f} "
          f"pipe 1 {busy[PIPE_STAGES[1]][0] / 1e3 / wall1:.3f} sequential "
          f"{busy['sequential'][0] / 1e3 / seq_wall:.3f} ({smi})", flush=True)
    if counts != want or counts1 != want:
        fail(f"pipeline (n): launches {counts} / {counts1} != {want}")
    if not bitwise:
        fail("pipeline (n): pipe 4 differs from pipe 1")
    if not all(np.isfinite(x) for x in (l4.item(), seq_loss)) or not all(
            lg <= TRAIN_LOSS_REL_TOL and gg <= TRAIN_GRAD_REL_L2_TOL for lg, gg in gaps.values()):
        fail(f"pipeline (n): the pipelined step differs from forward_train: {gaps}")
    if not all(leaf[s][n] <= TRAIN_GRAD_REL_L2_TOL for s in PIPE_STAGES for n in front):
        fail(f"pipeline (n): a leaf the pipe writes differs from forward_train's: {worst}")
    del runs, seq, g4, g1
    pipe_attention_check(torch, model, lambda: pipelined(PIPE_STAGES[0])(), gen, smi)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # the dry run's entry point on one NCCL rank
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
           "--master_addr", "127.0.0.1", "--master_port", str(free_port()), "-m",
           "edm_tts_tpu_torch.dryrun_multichip"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if " OK" in ln]
    print(f"pipeline (n) torchrun --nproc_per_node 1 -m edm_tts_tpu_torch.dryrun_multichip: "
          f"exit {proc.returncode} in {wall:.1f} s: {lines} ({smi})", flush=True)
    if proc.returncode != 0 or not lines:
        fail(f"dryrun_multichip exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
             f"{proc.stderr[-3000:]}")
    return counts


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--source-faults", action="store_true",
                      help="plant SOURCE_FAULTS in copies of K1's and K2's, K3's, K4's, "
                           "K5's and K6's sources; each must be rejected")
    mode.add_argument("--attention-kernels", action="store_true",
                      help="only the K3-with-LSE/K4 and ragged K6 cases of the kernel "
                           "phase; exit 3 when one is outside its limits")
    mode.add_argument("--int8-kernels", action="store_true",
                      help="only the K5 cases of the kernel phase; exit 3 when one is "
                           "outside its limits")
    mode.add_argument("--codec-kernels", action="store_true",
                      help="only K1's one-request cases and K2's cases of the kernel phase; "
                           "exit 3 when one is outside its limits")
    mode.add_argument("--f32-kernels", action="store_true",
                      help="only the f32 K3, K4 and K5 cases of the kernel phase; exit 3 when "
                           "one is outside its limits")
    mode.add_argument("--closed-loop", action="store_true",
                      help="only the build, the Conformer API check and the closed-loop "
                           "rehearsal (l); exit 3 when a check fails")
    mode.add_argument("--pipeline", action="store_true",
                      help="only the build and the GPipe path (n); exit 3 when a check fails")
    mode.add_argument("--dp-step", default=None, metavar="DIR",
                      help="(path (m)'s own process, under torchrun) the data-parallel s2a "
                           "steps on the shards in DIR")
    parser.add_argument("--parent", default=None, metavar="DIR",
                        help="another checkout of this repository whose K2 front (the "
                             "10-argument edm_tconv_phase of before PR 8) to time beside this "
                             "one's in K2's cases")
    parser.add_argument("--parent-f32", default=None, metavar="DIR",
                        help="another checkout of this repository (the parent of the K3-f32 "
                             "redesign) whose K3-f32 and K4-f32 (parent_f32_kernels) to time "
                             "beside this one's in their cases")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this smoke run needs an NVIDIA GPU")
    if args.source_faults:
        return source_faults()
    if args.dp_step is not None:
        return dp_step_worker(args.dp_step)
    from edm_tts_tpu_torch import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    part = ("attention" if args.attention_kernels else "int8" if args.int8_kernels
            else "codec" if args.codec_kernels else "f32" if args.f32_kernels else None)
    parent_front = parent_f32 = None
    if args.parent is not None:
        from edm_tts_tpu_torch.profile_decoder_block import parent_front as build_parent_front
        parent_front = build_parent_front(Path(args.parent))
    if args.parent_f32 is not None:
        parent_f32 = parent_f32_kernels(torch, Path(args.parent_f32))
    if part is not None:
        try:
            kernel_phase(torch, ops, part, parent_front, parent_f32)
        except CheckFailed as e:
            print(e.code, file=sys.stderr, flush=True)
            return 3
        return 0
    from edm_tts_tpu_torch.kernels import all_launches, build, reset_launches
    from edm_tts_tpu_torch.models.s2a import s2a_sample
    from edm_tts_tpu_torch.models.t2s import t2s_sample
    from edm_tts_tpu_torch.pipeline import e2e_synthesize
    from edm_tts_tpu_torch.profile_tokenization import full_width_semantic
    from edm_tts_tpu_torch.profile_synthesis import (
        GEN_FRAMES,
        PRED_ITERS,
        STEPS,
        bench_inputs,
        full_width_models,
    )

    dev = torch.device("cuda", 0)

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s", flush=True)

    if args.pipeline:
        try:
            pipeline_path(torch, dev, smi)
        except CheckFailed as e:
            print(e.code, file=sys.stderr, flush=True)
            return 3
        return 0

    if args.closed_loop:
        try:
            conformer_api_check(torch, full_width_models(dev, SEED)[0], dev)
            gc.collect()
            torch.cuda.empty_cache()
            closed_loop_path(torch, dev, smi)
        except CheckFailed as e:
            print(e.code, file=sys.stderr, flush=True)
            return 3
        return 0

    # 3. kernels against their plain versions
    cases = kernel_phase(torch, ops, parent_front=parent_front, parent_f32=parent_f32)

    # 4. end to end at full width
    t0 = time.perf_counter()
    t2s, s2a = full_width_models(dev, SEED)
    t2s_cfg, s2a_cfg = t2s.cfg, s2a.cfg
    n_params = sum(p.numel() for m in (s2a, t2s) for p in m.parameters())
    print(f"models: {n_params / 1e6:.1f}M parameters in {time.perf_counter() - t0:.2f} s", flush=True)
    inp = bench_inputs(s2a_cfg, dev, SEED)
    text, text_len, gt_length = inp["text"], inp["text_len"], inp["gt_length"]
    prompt_ac, prompt_sem = inp["prompt_ac"], inp["prompt_sem"]
    hop = s2a_cfg.codec.hop_length
    n_samples = s2a.acoustic_model.decoded_length(GEN_FRAMES)

    def request(full_canvas: bool, seed: int):
        return e2e_synthesize(
            t2s, s2a, text, text_len, prompt_ac, prompt_sem,
            torch.Generator().manual_seed(seed), pred_iters=PRED_ITERS, steps=STEPS,
            max_speech_len=GEN_FRAMES, gt_length=gt_length if full_canvas else None,
            assume_full_canvas=full_canvas,
        )

    def expected_launches(full_canvas: bool) -> dict:
        attention = (t2s_cfg.main_encoder_num_layers * PRED_ITERS
                     + (0 if full_canvas else t2s_cfg.length_predictor_num_layers)
                     + (s2a_cfg.injection_layers[0] + 1) * STEPS + s2a_cfg.encoder_num_layers)
        # K2 takes the blocks the JAX package fuses: even stride dividing 40,
        # C_out <= 192 (decoder.py); K1 every residual unit of the decoder
        codec = s2a_cfg.codec
        fused = sum(1 for i, s in enumerate(codec.decoder_rates)
                    if s % 2 == 0 and 40 % s == 0 and codec.decoder_dim // 2 ** (i + 1) <= 192)
        return no_launches(resunit=3 * len(codec.decoder_rates), decoder_block=fused,
                           attention=attention)

    def check(label: str, out, full_canvas: bool, counts: dict):
        audio = out["audio"]
        if tuple(audio.shape) != (1, n_samples, 1):
            fail(f"{label}: audio shape {tuple(audio.shape)} != (1, {n_samples}, 1)")
        length = int(out["lengths"][0])
        valid = audio[:, : length * hop].float()
        rms = valid.square().mean().sqrt().item()
        if not torch.isfinite(audio).all() or not rms > 0:
            fail(f"{label}: audio not finite or silent (rms {rms})")
        codes, sem = out["acoustic_codes"], out["semantic_tokens"]
        if tuple(codes.shape) != (1, s2a_cfg.num_quantizers, GEN_FRAMES):
            fail(f"{label}: codes shape {tuple(codes.shape)}")
        if codes.min() < 0 or codes.max() >= s2a_cfg.num_codevectors:
            fail(f"{label}: codes out of range")
        if sem.min() < 0 or sem.max() >= t2s_cfg.semantic_vocab_size:
            fail(f"{label}: semantic tokens out of range")
        want = expected_launches(full_canvas)
        print(f"e2e {label}: audio {tuple(audio.shape)} length {length} frames "
              f"rms {rms:.4f} launches {counts} expected {want}", flush=True)
        if counts != want:
            fail(f"{label}: kernel launches {counts} != expected {want}")

    # (a) bench.py's request: gt_length 500 on the full canvas
    reset_launches()
    out_a = request(True, SEED)
    torch.cuda.synchronize()
    counts_a = all_launches()
    check("(a) full canvas", out_a, True, counts_a)

    # the same codes decoded through the plain versions agree with the kernels
    plain_audio = decode_plain(torch, ops, s2a.acoustic_model, out_a["acoustic_codes"])
    rel = rel_l2(torch, out_a["audio"], plain_audio)
    print(f"e2e (a) decode vs plain versions: relative l2 error {rel:.4g} "
          f"(tol {DECODE_REL_L2_TOL})", flush=True)
    if not rel <= DECODE_REL_L2_TOL:
        fail(f"decode differs from the plain versions: relative error {rel}")

    # (b) the length predictor and the masked canvas
    reset_launches()
    out_b = request(False, SEED + 1)
    torch.cuda.synchronize()
    counts_b = all_launches()
    check("(b) predicted length", out_b, False, counts_b)

    # wall seconds per second of audio of (a), after the warm-up above
    audio_s = GEN_FRAMES * hop / s2a_cfg.codec.sample_rate
    walls = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        request(True, SEED + 10 + i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f"e2e (a) rtf: {wall / audio_s:.5f} s per audio s (median wall {wall:.4f} s of "
          f"{[round(w, 4) for w in walls]}, {audio_s:.1f} s audio, {smi})", flush=True)

    # where the wall time of (a) goes, stage by stage
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0

    gen = torch.Generator().manual_seed(SEED + 20)
    t2s_out, t_t2s = timed(lambda: t2s_sample(
        t2s, text, text_len, gen, pred_iters=PRED_ITERS, max_speech_len=GEN_FRAMES,
        gt_length=gt_length))
    codes, t_s2a = timed(lambda: s2a_sample(
        s2a, t2s_out["semantic_tokens"], prompt_ac, prompt_sem, gen, steps=STEPS))
    _, t_dec = timed(lambda: s2a.decode_audio(codes))
    print(f"e2e (a) stages: t2s {t_t2s:.4f} s, s2a {t_s2a:.4f} s, decode {t_dec:.4f} s", flush=True)

    # the Conformer API on the bf16 t2s: the early exit and the attention maps
    counts_api = conformer_api_check(torch, t2s, dev)

    # 5. (c) the served path with int8 weights (quantizes the models in place),
    # its engine holding (g)'s HuBERT-large
    t0 = time.perf_counter()
    semantic = full_width_semantic(dev, SEED + 50)
    print(f"models: HuBERT-large to layer {semantic.output_layer} with "
          f"{semantic.cluster_centers.shape[0]} centroids, "
          f"{sum(p.numel() for p in semantic.parameters()) / 1e6:.1f}M parameters in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    held = {(c["m"], c["k"], c["n"]) for c in cases["int8_dense"]}
    held_k1 = {(c["b"], c["t"], c["c"], c["dilation"]) for c in cases["resunit"]}
    counts_c, engine = served_path(torch, t2s, s2a, semantic, dev, smi, held, held_k1)

    # 6. (g) prompt tokenization through the same engine
    counts_g = tokenization_path(torch, ops, engine, dev, smi, held_k1)
    del t2s, s2a, semantic, engine
    gc.collect()  # so that no model of (a)-(g) counts in (d)'s peak memory
    torch.cuda.empty_cache()

    # 7. (h) model directories, the inference and serve CLIs, the f32 engine
    counts_h = cli_path(torch, ops, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # 8. (d) s2a training at full width
    counts_d = training_path(torch, ops, dev, smi)

    # 9. (e) t2s training at full width
    counts_e = t2s_training_path(torch, ops, dev, smi)

    # 10. gradient checkpointing on the full-width s2a
    remat_path(torch, dev, smi)

    # 11. (f) the attention-variant ablation through the profiling script
    counts_f, _ = ablation_path(torch, smi)

    # 12. (i) f32 training: the s2a and t2s recipes with bf16: false
    counts_i = f32_training_path(torch, ops, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # 13. (j) offline preprocessing: hubert_kmeans, dump_tokens, a step on the shards
    counts_j = preprocessing_path(torch, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # 14. (k) codec GAN training, the export's bf16 round trip, K1/K2 gradients
    counts_k = codec_training_path(torch, ops, dev, smi, held_k1)
    gc.collect()
    torch.cuda.empty_cache()

    # 15. (l) the closed-loop rehearsal at full width through the port's CLIs
    counts_l = closed_loop_path(torch, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # 16. (m) the multi-device layer: a one-rank torchrun data-parallel step, engine replicas
    counts_m = multi_device_path(torch, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # 17. (n) GPipe on one card: a local pipe of 4 against 1 and the sequential step,
    # then dryrun_multichip on one NCCL rank
    counts_n = pipeline_path(torch, dev, smi)

    by_path = {"a": counts_a, "b": counts_b, "c": counts_c, "g": counts_g, "h": counts_h,
               "d": counts_d, "e": counts_e, "f": counts_f, "i": counts_i, "j": counts_j,
               "k": counts_k, "l": counts_l, "m": counts_m, "n": counts_n, "api": counts_api}
    record = {"kernels": []}
    for name in KERNELS:
        cs = cases[name]
        lib = [c["library_ms"] for c in cs]
        ops_share = sum(c["bound_ms"] for c in cs if c["bound_by"] == "operations")
        record["kernels"].append(dict(
            name=name, route="cuda", **KERNELS[name],
            # the path the kernel runs on: K2 is off on the served masked
            # decode, K4 runs on the training paths only, K6 on the ablation,
            # the f32 K3/K5 on (h)'s f32 engine, the f32 K4 on (i)
            launches=next((c[name] for c in (counts_c, counts_a, counts_d, counts_f, counts_h,
                                             counts_i) if c[name]), 0),
            launches_by_path={p: c[name] for p, c in by_path.items()},
            max_abs_err=max(c["max_abs_err"] for c in cs),
            rel_l2=max(c["rel_l2"] for c in cs),
            ms=sum(c["ms"] for c in cs),
            plain_ms=sum(c["plain_ms"] for c in cs),
            bound_ms=sum(c["bound_ms"] for c in cs),
            bound_by="operations" if ops_share * 2 >= sum(c["bound_ms"] for c in cs) else "bytes",
            library_ms=None if None in lib else sum(lib),
            cases=cs))
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
