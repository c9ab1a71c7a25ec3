#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (rga3_tpu_torch) end to end on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

It runs itself again with PYTHONHASHSEED = N unless it already has it: the
processor's word tokenizer maps words through Python's str hash, so that a
run is reproducible from the seed only with it fixed.

Phases, each timed on its own line:
  1. device: the card, its power limit, TF32 off for the comparisons;
  2. build: the CUDA kernels from rga3_tpu_torch/csrc with nvcc; ptxas's
     registers and spills for each kernel, and no spill in the tensor-core
     kernels (NO_SPILL); the card count, and with more than one card one
     launch of each kernel on cuda:1 (PyTorch's current device left at 0)
     against its plain version there (`second_card_check`); with one card
     the log says that this was not exercised;
  3. main path: `UniGRSegmentor.segment_video_multi` with UniGR at the release
     width (Qwen2.5-VL-7B + SAM2 Hiera-L at 1024^2, the default `Sam2Config()`
     with every Hiera fusion on), random bf16 weights made on the card from
     the seed, on an 8-frame 480x854 video with 2 expressions, then once more
     warm, then once more under torch.profiler (device time by kernel, and
     the device's busy share of the untraced warm call). The wrappers' launch
     counts and the calls they saw are reset just before the first call and
     read just after it; each kernel must have been launched, and the fused
     Hiera wrappers as often as Hiera-L's blocks say;
  3b. eval: the benchmark drivers through their CLIs (`eval_vos.main`,
     `eval_img.main`) at the same width on a model the CLI builds from the
     seed (`--model_dir dummy --model_size 7b`): a synthetic MeViS tree
     (EVAL_FRAMES frames at 720x1280, EVAL_EXPRESSIONS expressions, moving
     ellipses over noise as the ground truth) under build/eval_phase/,
     infer cold (its launches counted), warm into a fresh tree (the same
     bytes) and traced (the busy share, from a device-only trace; the PNGs
     are encoded on the driver's threads); the PNGs equal to a direct
     `segment_video_multi` of the frames read back, bit for bit; a resume
     that writes nothing; the eval stage (EVAL_WORKERS spawned workers)
     against the J&F of the direct masks; then `eval_img` on EVAL_IMAGES
     ReasonSeg-layout images, gIoU / cIoU equal to direct `segment_video`
     calls (its launches a path of their own); seconds a stage, an
     expression and an image, PNG writing, peak memory;
  4. chat: `UniGRChat.answer` on the same video with the same bf16 weights
     (the float LM, a bf16 KV cache, 64 new tokens), then on an int4 serving
     copy of the Qwen2.5-VL weights (`quantize_for_serving(..., "int4")` on
     the card: int4 LM, int8 vision tower) cold, warm and traced, and one
     `answer_batch` of 4 questions; int4_matmul must be launched 197 times a
     forward (28 layers x 7 projections + lm_head). KV-cached decode is held
     against one forward without a cache over the prompt and the generated
     tokens; then one answer with the int8 options (int8 LM and tower, W8A8
     prefill, int8 KV cache). Each chat path is a path of its own: counts
     reset before its cold call and read after it;
  4b. stom: STOM region QA (BASELINE config 5) on the int4 chat of phase 4:
     `run_inference(chat_int4, 2 VideoInfer items, use_stom=True,
     batch_size=2)` (a rectangle overlay on key frame 0, a mask overlay on
     key frame 3) with CoTracker3 at the official width (the config of
     `cotracker3_official.npz`: 160x224, 4 iterations, bf16; random weights
     from the seed at flax's initialiser scales; no weight file is read),
     its launches counted from the cold call; the tracker's seconds a clip
     cold and warm, single and batch of 2, N per item, the STOM leg against
     the answer_batch leg, peak memory, the busy share of a warm
     `propagate_in_video` with its top device ops; the tracker in f32 (TF32
     off) on the card against the CPU at one refinement iteration (tracks
     within TRACK_TOL_PX, logits within LOGIT_TOL of their max, composited
     frames byte-identical but near rounding ties; four iterations logged
     beside the CPU's own sensitivity), track_batch against track in f32,
     and in bf16 each iteration of the batch's forward against single ones
     (iteration 1 within BATCH_BF16_FACTOR of bf16 against f32 on the card,
     bf16 card against bf16 CPU logged beside);
  4d. region_qa: the region-QA benchmark CLIs on phase 4's int4 chat
     (`main(argv, model=...)`), STOM over phase 4b's CoTracker3 written by
     `save_cotracker3` (flax layout, f16) under build/region_qa/ and named
     by RGA3_STOM_TRACKER:
     `eval_videoinfer` on a VideoInfer tree (REGION_VIDEOS videos x
     REGION_FRAMES frames at REGION_SIZE, a rectangle and a mask overlay a
     video, 8 QA) with --use_stom --batch_size 4 in 2 shards (the union the
     8 ids, a resume that writes nothing), merge, eval (the scores equal to
     `evaluate_captions` of the merged file); `eval_region_qa --bench
     videorefer` on 2 items of REFER_FRAMES frames (16 sampled, STOM, 16
     new tokens) through a recording proxy of the chat, each record's pred
     the first character of a direct answer of the prompt and frames the
     driver built, then its eval stage; `--bench vipbench` on 4 images at
     VIP_SIZE in batches of 2 (the banned ids hold [SEG]'s, none of them
     generated); each CLI a path of its own (int4_matmul 197 a forward,
     flash_attention launched); STOM over LK on phase 4b's items (seconds
     a clip on the host) and on a textured patch shifted by a known step a
     frame (the rectangle within 1 px); phase 4b's tracker exported to the
     official checkpoint layout, `torch.save`d and rebuilt by
     `build_cotracker3_from_checkpoint` (config equal to `stom_config()`,
     outputs bit-equal);
  4e. stom_train: STOM's tracker trained through `python -m
     rga3_tpu_torch.tools.train_cotracker`'s `main` (no kernel of the port:
     the counts reset before the phase and read after it must be 0): the
     layered curriculum at the official CoTracker3 dims (STOM_TRAIN_ARGV:
     bf16, batch 8 at 160x224, 4 training iterations, mixed textures) for
     STOM_TRAIN_STEPS steps from a pool of STOM_POOL clips (the release run:
     6000 steps, pool 512), its `save_cotracker3` file read back by
     `load_cotracker3` (bit-equal to the weights rounded to f16), a
     `--resume` from it (starting from those weights) for STOM_RESUME_STEPS;
     the flat curriculum with CoTrackerLite at its default width for
     STOM_LITE_STEPS; one layered step in f32 on the card against the CPU
     from the trained weights and one batch at one refinement iteration
     (loss, aux px errors, each tensor's gradient and the parameters'
     moves gated; four iterations logged); `default_tracker()` under
     `RGA3_STOM_TRACKER=<file>` on phase 4b's items; `bench_stom_synth` on
     the file (fixed and serving suites, finite; a ground-truth oracle
     scores 0). Logged: host seconds a
     `make_training_clip` at 160x224 (noise, photo), seconds a step cold and
     warm, the wait on the pool and fresh clips a step, peak memory, the
     busy share of a warm layered step and its top device ops;
  4c. serve: the demo server's service from `rga3_tpu_torch.serve`'s
     `build_service` (`--model_dir dummy --model_size 7b --int4 --draft_dir
     dummy --spec_k 4`: the int4 UniGR, int8 tower, SAM2 Hiera-L, random
     weights from the seed, and a bf16 Qwen2.5-VL-3B draft), the int4
     UniGR written by `save_quantized` under build/ and built again from
     that directory (every tensor bit-equal); then `serve` on a free
     localhost port with a `load_video` for uploaded .npy frames (this
     phase decodes no video file; phase 6b decodes mp4 with OpenCV),
     driven over HTTP: /health and /, /api/qa plain,
     through the target as its own draft and through the 3B draft (each
     answer the direct plain greedy answer of the same frames), four
     concurrent /api/qa coalesced by the batcher (each answer the direct
     answer_batch's, in the batcher's order), /api/segment (its RLEs
     decode to the direct `segment_video` masks); each request a path (its
     launches read after its cold call); request wall over HTTP against
     the direct call, ms per token by decode route, acceptance, the
     self-draft's forwards timed one by one (M = 1 against the M = 5
     verify), peak memory;
  5. plain route: the same LLM forward and one SAM chunk with attention and
     the fused blocks routed to the plain versions, on the same weights; then
     the earlier unfused Hiera path (`unfused(cfg)`) on the
     same weights, its own launches counted, against the fused route, and
     the two routes' SAM encode of one chunk timed in six alternating pairs;
  5b. tracker: `track_video` (the SAM2 memory tracker) on the same weights
     and the 8 frames resized to 1024^2 on the card, O = 2 objects prompted
     by the 2 expressions' [SEG] embeddings (cold, warm, traced), then by
     one positive click each; each a path of its own (counts reset before
     its cold call); 56 flash launches at head dim 256 per track (4 memory
     attention layers x self + cross x 7 frames), shapes and finite values,
     seconds per track, frames/s, peak memory, the device's busy share; the
     kernel route against the plain route on frame 1, the first frame that
     reads memory (frames 2-7 logged);
  5c. legacy: `UniGRLegacy` (SAM-v1 ViT-H at 1024^2, random from the seed)
     sharing phase 3's Qwen2.5-VL-7B: `segment_video_multi` on the same
     video and expressions cold (its launches: the flash forward, no Hiera
     wrapper) and warm, masks of the video's size, finite low-resolution
     logits; one `train_forward` + backward on phase 6's batch (a finite
     loss, the flash backward once per LM layer and decoder image->token
     attention); seconds and peak memory;
  5d. switches, on phase 3's weights, each against its default route: the
     vision tower with `window_resident` (each block on the resident
     route's own input, pad slots and all, per row within ROW_TOL; the
     tower end to end in f32 with plain attention within RESIDENT_F32_TOL,
     and in bf16 within RESIDENT_SPREADS times the default route's own
     bf16-vs-f32 error; the flash forward over the padded window stream),
     the single-mask decode
     by stability (each frame's mask the stable first one or the default
     route's best, bit for bit) and a mask-prompted `forward_sam_heads`,
     one SAM chunk under `RGA3_GELU_EXACT=1` (every fused block's call the
     erf GELU, the masks agreeing), and `segment_video_multi` with
     `device_preprocess=True` (features and masks against the host route);
     the resident, erf and device-preprocessing calls are paths of their
     own;
  6. train: `build_train_step` on the same UniGR (the release LoRA, r=128,
     alpha=256, whose zero B left the earlier phases' outputs unchanged;
     trainable LoRA, lm_head, embed_tokens, the SAM2 mask decoder and
     text_hidden_fcs; remat "none"), TRAIN_STEPS steps on one batch of 2
     samples collated by the port from the video (512 tokens, 320 merged
     video tokens a sample, 4 SAM frames at 1024^2, random 0/1 gt masks),
     the first cold with its launches counted (flash_attention_bwd once per
     LM layer and per decoder image->token attention), then one traced;
     the losses finite and falling, frozen weights bit-identical, trainable
     ones moved (by checksums), peak memory, the kernel route's gradients
     against themselves (a second backward: its loss bit-equal, the
     gradients' run-to-run spread) and against the plain route's on the
     same weights and batch; then the backbone unfrozen
     (`freeze_sam_backbone=False`) on the same weights and batch: the loss
     bit-equal to the frozen one, the image encoder's gradients non-zero in
     every Hiera stage and the neck, the trainable gradients within
     UNFROZEN_SPREADS times that spread of the frozen step's, one
     step (lr fixed) leaving the encoder bit-identical, its seconds
     (forward / backward / optimizer) and peak memory beside the frozen
     step's;
  6b. train CLI: `python -m rga3_tpu_torch.train`'s `main`, under a
     process group of one rank (NCCL, world size 1, `--mesh_data 1`: the
     sharded optimizer's collectives, the all-reduced loss normalisers, the
     rank-0 checkpoint behind its barrier and the broadcast val metric; the
     NCCL init seconds, and the device time of the step's collectives in
     the traced warm step), at the release
     configuration (`configs/release_7b.json`: Qwen2.5-VL-7B with LoRA r 128
     + SAM2 Hiera-L at 1024^2, 8 MLLM / 4 SAM frames, micro-batch 2, grad
     accum 8, the ten-dataset mixture at its rates, remat "dots", f32
     masters, SAM2 (the frozen Hiera-L encoder on the f32 kernels of
     `csrc/f32_ops.cu`), text_hidden_fcs and the LM's embedding and head
     held and computed in f32 as JAX's f32 parameters make them,
     `cli.hold_f32`) on a model it builds itself (`--model_dir dummy`: the JAX
     script's crc32-seeded draws, the LM's layers from its scanned paths;
     run 2 copies run 1's draws, the same values), over a synthetic tree in every published
     layout under build/train_cli/ (`write_train_tree` at TRAIN_CLI_SIZES:
     COCO-size stills, 720p frame folders, an 8-second 480x854 mp4 written
     and decoded with OpenCV, a ReasonSeg val split of `val_images` images
     at 768x1024, all of them validated), 2 prefetch threads; the only cut
     is the steps (1 an epoch). Run 1: val at start, one step (its
     launches counted: the flash forward of the LM with segment ids and of
     the ViT; the f32 encoder's kernels at Hiera-L's counts x the
     micro-batches (HIERA_L_F32_LAUNCHES, the decoder's two image->token
     attentions on the f32 flash forward) and none of the bf16 Hiera
     kernels; the flash backward once per LM layer per micro-batch), val,
     a checkpoint. Run 2 (`--epochs 2`): the auto-resume restores the state
     bit for bit (checksums of every trainable tensor, master and moment),
     the optimizer's count continues, the step's lr is the schedule's at
     step 1 and its accumulation batch index the resume offset; then one
     step, val and a checkpoint. Losses finite, `meta_log_info.json` right.
     Logged: seconds a step and a micro-batch, host seconds an
     accumulation batch and the step's wait on the loader, val seconds and
     gIoU / cIoU, checkpoint seconds and bytes, peak memory, "dots" against
     "none" on one micro-batch (peak memory, seconds), the unfrozen f32
     encoder's forward + backward on it (`freeze_sam_backbone` off: its
     peak memory, or that it does not fit), the busy share of a
     warm step and its model FLOPs and MFU (`utils.flops`,
     `utils.profiling`); then run 2's trained state exported by
     `train.export.export_hf_safetensors` into build/export/ (LoRA merged,
     f32, HF names; seconds, GB, the free disk and host RAM before) and
     read back on the host by `load_unigr_state_dict`, bit-equal to the
     merged state in the process;
  6c. hand-off: `data/polygon.py` against this machine's OpenCV on 6,000
     random polygons (the count that differ logged); the export quantized
     by `python -m rga3_tpu_torch.tools.quantize_checkpoint --bits 4` on the
     card into build/export_q4/ (seconds, GB); the server's service built
     by `build_service --model_dir build/export_q4` (the run's dummy word
     tokenizer: the card has no transformers), every tensor bit-equal to an
     in-process `quantize_for_serving(..., "int4")` of the export as 6b read
     it back;
     one /api/qa and one /api/segment over localhost, each a path counted
     from its cold call (int4_matmul 197 launches a forward, the Hiera
     wrappers as Hiera-L's blocks say), the answer equal to `UniGRChat.answer`
     and the RLEs to `segment_video` of the in-process model; the
     quantized directory deleted (the export stays for 6e);
  6d. tensor: the mesh's tensor axis on the one card: two ranks, processes
     of their own beside this one, in a gloo group (NCCL refuses two ranks
     on one card; gloo carries CUDA tensors' all-reduce, and the port's
     all-gathers go through it there, logged), each holding its blocks of a
     Qwen2.5-VL-7B-width model whose LM is cut to TP_LAYERS layers (the
     cut logged; the full depth runs on four cards), drawn from the seed
     one leaf at a time (`tools/generate_ranks.build_seeded`). Greedy
     generation (B = TP_BATCH, TP_PROMPT + TP_NEW tokens) in bf16 and in
     int4 (the LM quantized leaf by leaf, then cut): under teacher forcing
     on this process's one-rank tokens the logits within TP_TOL of the
     step's max|logit|, the tokens equal wherever the one-rank top-2 gap
     exceeds it; then TP_TRAIN_STEPS train steps of the UniGR (release
     LoRA, SAM2 Hiera-L) on phase 6's batch: the losses and gradient norms
     equal on both ranks and within TP_LOSS_RTOL / TP_NORM_RTOL of one
     rank's, each trainable tensor's move within TP_MOVE_TOL of one rank's
     in L2 (the vocabulary-sharded ones at the batch's rows), the tensors
     whole over tensor bit-equal on both ranks. Each rank's counts are reset
     before each run and read after it (flash forward, int4 and the flash
     backward launched at the ranks' head counts and blocks); rank 0's
     calls join phase 7's. Logged: held bytes, peak memory, prefill and
     decode seconds, step seconds, each process's;
  6e. verify: `python -m rga3_tpu_torch.tools.verify_checkpoints` in
     real mode on 6b's export (7B + Hiera-L read in bf16, the dummy word
     tokenizer: the export has none), `--samples 1 --skip_act_diff` (the
     card has no transformers; the CPU tests hold act_diff): load, configs
     1-8 at 7B (int4 serving, speculative decoding, STOM, the int8
     save / load round trip bit-equal) and config 9, the learned tiny
     checkpoint in bf16 (its 2x2 Hiera windows on the window kernel's
     packed small windows), gIoU above 0.5; every stage's ok and seconds
     logged, any failure fails the run; its path counted; the export
     deleted;
  7. kernels: each hand-written kernel, and each fused-block wrapper built
     from them, against its plain PyTorch version at every call the paths
     made (shapes, strides, options, segment ids: the flash forward at
     each distinct segment ids its recorded launches had, so the tracker's
     cross-attention at every bank it saw; bf16 inputs; per
     output row within ROW_TOL of the row's max|plain|; the f32 variants
     in f32 within F32_TOL, TF32 off, against cuBLAS f32 and SDPA's math
     path as the library, the f32 GEMM's and attention's bound at the
     3xTF32 peak (PEAK_3XTF32_FLOPS) with their share of the CUDA cores'
     f32 bound beside it, the row kernels' at the f32 peak; the flash backward
     against `flash_attention_bwd_reference`, dq, dk and dv per row), with
     its time, its bound, the plain version's time and the time of the same
     function composed of PyTorch library calls
     (`scaled_dot_product_attention` and its backward, `linear`,
     `layer_norm`, `gelu`, `max_pool2d`; for int4_matmul `linear` on the
     weight dequantized to bf16 once: a yardstick only, the port never calls
     them), the share of its bound, and TFLOP/s for each attention,
     backward, gemm and int4 call; each int4 call is launched twice and
     must give equal bits;
  8. reference: a small model with the fused Hiera routes (and the split
     window block) on the card against the same model in f32 on the CPU,
     its 2-frame track (the memory encoder and the bank; the dense memory
     attention), a tiny `UniGRLegacy` (SAM-v1) likewise, and a small int4
     chat on the card against the same quantized model on the CPU (prefill
     and teacher-forced decode logits).

The line before the last is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before it. Without
a CUDA device, or outside the repository, the script exits non-zero.
"""
from __future__ import annotations

import argparse
import copy
import hashlib
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# per output row (b, token, head): max_d |kernel - plain| <= ROW_TOL * max_d
# |plain|. bf16 outputs on both sides, f32 accumulation in both: a right
# kernel differs by about one bf16 ulp of the row's largest value (2^-7 of
# it); a kernel that skipped a quarter of the keys would be off by ~1x.
ROW_TOL = 2e-2
# the f32 variants (csrc/f32_ops.cu, the encoder under f32 parameters), per
# output row against the f32 plain version with TF32 off (phase 1): f32
# outputs with f32 accumulation on both sides differ by a few f32 ulps
# (~1e-7) of the row's largest value; set before the first call
F32_TOL = 1e-4
# phase 2's second card: the largest difference against the plain version's
# largest value (bf16 outputs; the backward's f32 reference)
SECOND_CARD_TOL = 2e-2
REPS = 10  # timed launches per kernel shape, after one warm-up
ENCODE_PAIRS = 6  # fused/unfused SAM encodes timed in turns
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12  # H100 SXM FP32 on the CUDA cores, no tensor cores (data sheet)
# f32-accurate products on the tensor cores: the H100 SXM's dense TF32 rate
# (495 TFLOP/s, NVIDIA data sheet) over the three TF32 products of each f32
# product in the 3xTF32 split of csrc/f32_ops.cu
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
L2_ROTATE_BYTES = 100e6  # twice the H100's 50 MB L2: weights timed from device memory
CHAT_TOKENS = 64  # max_new_tokens of the chat phase
EOS, PAD = 151645, 151643
# the chat's logits against the same model's forward without a cache, per
# step: bf16 weights and activations, the cached decode in f32 einsums over
# a bf16 cache and the forward through the flash kernel round at different
# places, about one bf16 ulp (2^-8..2^-7) of the largest logit per layer
# output; a decode that read a wrong cache slot is off by the order of the
# logits themselves
CHAT_TOL = 5e-2
# flash launches at head dim 256 in one 8-frame track: Sam2Config's 4 memory
# attention layers x (self + cross) x the 7 frames that read memory
TRACK_D256 = 4 * 2 * 7
# the STOM tracker in f32 (TF32 off), card against CPU: tracks in input
# pixels, vis / conf logits against their max|logit|; composited frames
# byte-identical except where the mean flow lies within TIE_MARGIN px of a
# rounding tie; track_batch against per-clip track (tests/test_cotracker3.py:327)
TRACK_TOL_PX = 1e-2
LOGIT_TOL = 1e-3
TIE_MARGIN = 0.01
BATCH_TOL_PX = 5e-2
BATCH_VIS = 0.95
# bf16 track_batch against track at refinement iteration 1: within this
# factor of the same clip's bf16-vs-f32 difference (max and mean), as
# tests/test_torch_cotracker3_spread.py holds the port to the reference
BATCH_BF16_FACTOR = 1.25
# phase 4c: new tokens of the plain and self-draft answers, of the 3B-draft
# answer, the draft's proposals an iteration, the batcher's window
SERVE_TOKENS = 32
SERVE_DRAFT_TOKENS = 16
SERVE_K = 4
SERVE_WINDOW_MS = 250
# phase 4d: the region-QA trees (720p videos, ViP-Bench's images) and the
# ViP-Bench answers' new tokens
REGION_VIDEOS = 2
REGION_FRAMES = 24
REGION_SIZE = (720, 1280)
REFER_FRAMES = 32
VIP_SIZE = (768, 1024)
VIP_TOKENS = 32
# phase 4e: tracker training through the CLI. The layered run is STATUS.md's
# official-dims recipe (bf16, batch 8 at 160x224, 4 training iterations,
# mixed textures, 8 frames, 16 points); the cuts against the release run
# (6000 steps, pool 512) are its steps, the resume's and the pool
STOM_TRAIN_ARGV = ["--curriculum", "layered", "--arch", "cotracker3", "--preset", "official",
                   "--size", "160", "--width", "224", "--bf16", "--train-iters", "4",
                   "--batch", "8", "--frames", "8", "--points", "16", "--textures", "mixed"]
STOM_TRAIN_STEPS = 30
STOM_RESUME_STEPS = 10
STOM_POOL = 32
STOM_LITE_ARGV = ["--arch", "lite"]  # the flat curriculum at CoTrackerLite's default width
STOM_LITE_STEPS = 30
# the layered step in f32 on the card against the CPU (one refinement
# iteration, batch STOM_CHECK_BATCH, two steps on one batch: the first at lr
# 0, so the second moves each element by about lr x the sign of its
# gradient): the loss within STOM_LOSS_RTOL, the aux px errors within
# TRACK_TOL_PX, each tensor's gradient within STOM_GRAD_RTOL of the CPU's in
# L2, the parameters' moves apart by more than STOM_UPDATE_MAX x lr in at
# most a share STOM_UPDATE_SHARE of the elements, and within
# STOM_UPDATE_MEAN x lr in a tensor's mean over the elements whose gradients
# have one sign on both devices. f32 computes the encoder's convolution
# gradients (each before an instance norm) only to 1e-3 to 1e-2 of their
# L2 norm, on the CPU as on the card, so an element whose gradient is within
# that of zero takes a step of either sign: up to ~0.3% of such a tensor,
# counted in the share but not in a tensor's mean. A zero-gradient element
# (a conv bias before an instance norm or a key bias) moves within 1.5 x lr
# on both devices.
STOM_CHECK_BATCH = 2
STOM_LOSS_RTOL = 1e-4
STOM_GRAD_RTOL = 5e-2
STOM_UPDATE_MAX = 0.25
STOM_UPDATE_MEAN = 5e-3
STOM_UPDATE_SHARE = 1e-3
# phase 3b: the VOS driver's MeViS tree (a 720p video) and its eval workers
# (the card's host has 8 cores), the image driver's ReasonSeg images
EVAL_FRAMES = 64
EVAL_SIZE = (720, 1280)
EVAL_EXPRESSIONS = 8
EVAL_WORKERS = 8
EVAL_IMAGES = 8
EVAL_IMAGE_SIZE = (768, 1024)
TRAIN_STEPS = 5  # untraced train steps on one batch (the first at lr 0), then one traced
TRAIN_SAM_FRAMES = 4  # TrainConfig.num_frames_sam
TRAIN_VIDEO_TOKENS = 320  # merged video tokens a sample (4 temporal groups of <= 80)
# the kernel route's training loss against the plain route's (relative) and
# its gradients (relative L2): all trainable gradients as one vector against
# the plain route's (every call site plain), and each tensor against the
# same route with only the flash backward plain. bf16 weights and
# activations through 28 layers: the two routes round attention and the
# Hiera blocks at different places, and a random-weight network amplifies
# those differences in some small decoder gradients (up to ~0.3 relative L2
# with the decoder's code the same on both sides); with only the backward
# plain, a tensor differs by the backward's own rounding (~1e-2)
GRAD_TOL = 0.1
# the unfrozen step's trainable gradients against the frozen step's: at
# most this many times the frozen route's own run-to-run spread (JAX and
# the CPU hold them bit-identical; on the card the masks' bilinear resizes
# add with atomics in their backward, and the unfrozen graph sums some
# gradients in another order: 1.87x the spread on an H100)
UNFROZEN_SPREADS = 3
# the vision tower's window-resident route against its default route, end
# to end: in f32 with every attention plain (one function, rounded in
# different orders), per row max err / max|row|; in bf16, at most this many
# times the default route's own per-row error against its f32 plain self
RESIDENT_F32_TOL = 1e-4
RESIDENT_SPREADS = 2
LOSS_TOL = 1e-2
# phase 6b: the training tree's sizes (published widths; a few items a
# dataset, 12 frames a video folder) and its ReasonSeg val images
TRAIN_CLI_SIZES = dict(image=(480, 640), video=(720, 1280), frames=12, mp4=(480, 854),
                       mp4_frames=240, mp4_fps=30, items=3, val=(768, 1024), val_images=4)
TRAIN_CLI_MODEL = "7b"
# phase 6b's warm step when the encoder computed in bf16 (PERF.md §5, NVIDIA H100
# 80GB HBM3, 700 W), printed beside the f32 encoder's
BF16_ENCODER_WARM_STEP = 5.833
# phase 6d: the tensor axis on the one card, two ranks (processes) over gloo
# beside this process. The LM's depth is cut to TP_LAYERS (28 at 7B) so that
# three 7B-width models fit; the full depth runs on four cards
# (`tools/generate_ranks.py`, `tools/train_ranks.py`). Greedy generation of
# TP_NEW tokens after a TP_PROMPT-token prompt, B = TP_BATCH, in bf16 and
# int4; TP_TRAIN_STEPS train steps on phase 6's batch at a constant lr
TP_LAYERS = 4
TP_PROMPT, TP_NEW, TP_BATCH = 64, 16, 2
TP_TRAIN_STEPS = 2
TP_LR = 1e-4
# bf16 rounding of a random-weight net (the one rank's products and the
# ranks' split ones round differently, and the net amplifies it), read on an
# H100 at seeds 0-2 (gates about 1.5x to 4x the largest reading): the
# teacher-forced logits 1.80e-2 to 2.05e-2 of the step's max|logit| (bf16
# and int4; TP_TOL, and the tokens equal wherever the one-rank top-2 gap
# exceeds it), the losses 1.8e-4 to 3.8e-4 relative (TP_LOSS_RTOL), the
# gradient norms 1.9e-4 to 4.5e-4 (TP_NORM_RTOL), each LM tensor's move
# (LoRA A, B, the vocabulary rows) up to 0.123 of one rank's in L2
# (TP_MOVE_TOL), SAM2's decoder and text_hidden_fcs as one vector each up
# to 0.213 (TP_HEAD_MOVE_TOL). A LoRA gradient left unsummed over tensor
# fails the norm, move and rank-equality gates (tiny width on the CPU:
# 2.9e-2, 0.47 and 0.71) and passes the loss gate (5.9e-6)
TP_TOL = 3e-2
TP_LOSS_RTOL = 1e-3
TP_NORM_RTOL = 2e-3
TP_MOVE_TOL = 0.25
TP_HEAD_MOVE_TOL = 0.4
# the trainable tensors held to one rank's moves as one vector each
TP_MOVE_WHOLE = ("sam_mask_decoder", "text_hidden_fcs")
# the vocabulary-sharded trainable tensors, held to one rank at the rows of
# the batch's ids (a rank holds half the vocabulary of each)
VOCAB_ROWS = ("embed_tokens.weight", "lm_head.weight")
RELEASE_CONFIG = os.path.join(HERE, "configs", "release_7b.json")
# kernels (by name) that ptxas must compile without spills
NO_SPILL = ("flash_fwd_mma", "window_fwd_mma", "dkv_mma", "dq_mma", "gemm_kernel",
            "int4_tile_kernel", "gemm_3xtf32_kernel", "attention_3xtf32_kernel",
            "layer_norm_f32_kernel", "window_pool_f32_kernel", "layer_norm_bf16_kernel")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


# --------------------------------------------------------------------------
# each kernel against its plain version, at the calls the main path made
# --------------------------------------------------------------------------


def randn_strided(shape, stride, gen, dtype=None):
    """N(0, 1) values (bf16 unless `dtype`) in a tensor with the given shape
    and strides."""
    import torch

    t = torch.empty_strided(shape, stride, device="cuda", dtype=dtype or torch.bfloat16)
    return t.normal_(generator=gen)


def row_rel_err(out, ref, rows):
    """max over (b, row, h) of max_d |out - ref| / max_d |ref|, on `rows`
    (B, L) that have at least one valid key."""
    diff = (out.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1).clamp_min(1e-6)
    return (diff / scale)[rows].max().item(), diff[rows].max().item()


def plain_flash(q, k, v, kw):
    """`mha_reference`, over query rows in chunks of ~2 GiB of f32 logits
    when the call is not causal (the vision tower's full attention over
    four videos would need ~22 GiB at once); each chunk attends to every
    key, so the function is the same."""
    from rga3_tpu_torch.ops.attention import mha_reference

    b, lq, h, _ = q.shape
    step = max(64, (1 << 29) // (b * h * k.shape[1]))
    if kw["causal"] or lq <= step:
        return mha_reference(q, k, v, **kw)
    import torch

    seg = kw["segment_ids"]
    kv_seg = kw["kv_segment_ids"] if kw["kv_segment_ids"] is not None else seg
    return torch.cat([
        mha_reference(q[:, i:i + step], k, v, scale=kw["scale"],
                      segment_ids=None if seg is None else seg[:, i:i + step],
                      kv_segment_ids=kv_seg)
        for i in range(0, lq, step)], 1)


def distinct_segments(calls):
    """[((q_seg, kv_seg) or None, launches)] of the distinct segment ids
    among a recorded call's launches (None: a launch without them)."""
    import torch

    def same(a, b):
        if a is None or b is None:
            return a is b
        return all(x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))

    out = []
    for segs in calls:
        for entry in out:
            if same(entry[0], segs):
                entry[1] += 1
                break
        else:
            out.append([segs, 1])
    return [tuple(e) for e in out]


def check_flash(key, calls, gen, reps):
    """The forward kernel at one recorded shape, once for each distinct
    segment ids its launches had (the tracker's bank gains valid frames
    from frame to frame at one shape); the times, bound and errors of the
    call are the launch-weighted means (errors the max) over them."""
    parts = distinct_segments(calls)
    rs = [(check_flash_segments(key, segs, gen, reps), n) for segs, n in parts]
    if len(rs) == 1:
        return rs[0][0]
    total = sum(n for _, n in rs)
    for r, n in rs:
        log(f"  flash [{r['desc']}] x{n}: row err / max|ref| {r['rel']:.3e}, ms {r['ms']:.4f}, "
            f"bound_ms {r['bound'][0]:.4f} ({r['bound'][1]}), plain_ms {r['plain_ms']:.4f}, "
            f"library_ms {r['lib_ms']:.4f}, TFLOP/s {r['flops'] / r['ms'] / 1e9:.1f} "
            f"(library {r['flops'] / r['lib_ms'] / 1e9:.1f})")

    def mean(f):
        return sum(f(r) * n for r, n in rs) / total

    ops = mean(lambda r: r["bound"][0] * (r["bound"][1] == "operations"))
    bound_ms = mean(lambda r: r["bound"][0])
    first = rs[0][0]
    return dict(desc=f"{first['desc'].rsplit(' segments=', 1)[0]} segments: {len(rs)} distinct",
                err=max(r["err"] for r, _ in rs), rel=max(r["rel"] for r, _ in rs),
                ms=mean(lambda r: r["ms"]), plain_ms=mean(lambda r: r["plain_ms"]),
                lib_ms=mean(lambda r: r["lib_ms"]), flops=mean(lambda r: r["flops"]),
                bound=(bound_ms, "operations" if 2 * ops >= bound_ms else "bytes"))


def check_flash_segments(key, segs, gen, reps):
    import torch
    import torch.nn.functional as F
    from rga3_tpu_torch.ops.attention import flash_attention

    qshape, qstride, kshape, kstride, vstride, causal, scale = key
    b, lq, h, d = qshape
    lk, hkv = kshape[1], kshape[2]
    q = randn_strided(qshape, qstride, gen)
    k = randn_strided(kshape, kstride, gen)
    v = randn_strided(kshape, vstride, gen)
    qseg, kseg = segs if segs is not None else (None, None)
    kw = dict(causal=causal, segment_ids=qseg, kv_segment_ids=kseg, scale=scale)
    out = flash_attention(q, k, v, **kw)
    ref = plain_flash(q, k, v, kw)
    # the (q, k) pairs this call's masks allow: rows with none are only
    # checked for being finite (the kernel follows the TPU kernel's rule there)
    allowed = None
    if qseg is not None:
        allowed = qseg[:, :, None] == kseg[:, None, :]
    if causal:
        tril = torch.ones(lq, lk, dtype=torch.bool, device="cuda").tril()[None]
        allowed = tril if allowed is None else allowed & tril
    if allowed is None:
        rows, pairs = torch.ones(b, lq, dtype=torch.bool, device="cuda"), b * lq * lk
    else:
        allowed = allowed.expand(b, lq, lk)
        rows, pairs = allowed.any(-1), allowed.sum().item()
    if not torch.isfinite(out).all():
        raise AssertionError(f"flash {qshape}: non-finite output")
    rel, err = row_rel_err(out, ref, rows)
    if rel > ROW_TOL:
        raise AssertionError(f"flash {qshape}: row error {rel} > {ROW_TOL} of max|ref|")
    ms = time_ms(lambda: flash_attention(q, k, v, **kw), reps)
    plain_ms = time_ms(lambda: plain_flash(q, k, v, kw), max(2, reps // 4))
    del ref
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_kw = {"enable_gqa": True} if hkv != h else {}
    if qseg is not None and bool((qseg != qseg[0, 0]).any() or (kseg != qseg[0, 0]).any()):
        lib_kw["attn_mask"] = allowed[:, None]
    else:
        lib_kw["is_causal"] = causal
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, scale=scale, **lib_kw), reps)
    flops = 4.0 * h * d * pairs
    nbytes = 2.0 * (2 * b * lq * h * d + 2 * b * lk * hkv * d)
    if qseg is not None:
        nbytes += 4.0 * b * (lq + lk)
    valid = "" if kseg is None or causal else f" valid keys {int(allowed[:, 0].sum().item()) // b}/{lk}"
    desc = (f"B={b} Lq={lq} Lk={lk} H={h}/{hkv} D={d} causal={causal} "
            f"segments={'none' if qseg is None else qseg.unique().numel()}{valid}")
    return dict(desc=desc, err=err, rel=rel, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                bound=bound(flops, nbytes), flops=flops)


def flash_bwd_bound(b, lq, lk, h, hkv, d, pairs, segs):
    """The backward's least time: 10 * H * D flops per admitted (q, k)
    pair (S and dP recomputed, dV, dK and dQ: five D-long products), or its
    bytes (q, o, do, k, v and the f32 LSE read once; dq, dk, dv written
    once) over the memory rate."""
    flops = 10.0 * h * d * pairs
    nbytes = 2.0 * (4 * b * lq * h * d + 4 * b * lk * hkv * d) + 4.0 * b * h * lq
    if segs is not None:
        nbytes += 4.0 * b * (lq + lk)
    return bound(flops, nbytes)


def check_flash_bwd(key, segs, gen, reps):
    """The backward kernel against `flash_attention_bwd_reference` (with
    the plain log-sum-exp) at a recorded call: o and the kernel's LSE from
    the forward kernel, a random output gradient; dq per row with two or
    more valid keys (a row with one has an exact dq of zero, and both sides
    hold rounding noise there: those are held to 1e-3 of max|dq|), dk / dv
    per row. library_ms: the backward of SDPA (kv expanded to the q heads,
    the boolean mask), timed as `torch.autograd.grad` of its output."""
    import torch
    import torch.nn.functional as F
    from rga3_tpu_torch.ops import attention as tatt

    qshape, qstride, kshape, kstride, vstride, causal, scale = key
    b, lq, h, d = qshape
    lk, hkv = kshape[1], kshape[2]
    q = randn_strided(qshape, qstride, gen)
    k = randn_strided(kshape, kstride, gen)
    v = randn_strided(kshape, vstride, gen)
    qseg, kseg = segs if segs is not None else (None, None)
    kw = dict(causal=causal, segment_ids=qseg, kv_segment_ids=kseg, scale=scale)
    o, lse = tatt._flash_forward(q, k, v, qseg, kseg, causal, scale, with_lse=True)
    do = randn_strided(qshape, tuple(o.stride()), gen)
    dq, dk, dv = tatt.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    _, lse_ref = tatt.mha_reference(q, k, v, **kw, return_lse=True)
    ref = tatt.flash_attention_bwd_reference(q, k, v, o, lse_ref, do, **kw)
    allowed = tatt._allowed(b, lq, lk, q.device, causal, qseg, kseg)
    if allowed is None:
        n_keys = torch.full((b, lq), lk, device="cuda")
    else:
        n_keys = allowed.expand(b, 1, lq, lk).sum(-1)[:, 0]
    pairs = n_keys.sum().item()  # admitted (q, k) pairs of one head
    for name, t in (("dq", dq), ("dk", dk), ("dv", dv)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"flash_bwd {qshape}: non-finite {name}")
    rel_q, err_q = row_rel_err(dq, ref[0], n_keys >= 2)
    lone = dq[n_keys == 1]
    if lone.numel() and lone.float().abs().max().item() > 1e-3 * ref[0].float().abs().max().item():
        raise AssertionError(f"flash_bwd {qshape}: rows with one key have nonzero dq")
    kv_rows = torch.ones(b, lk, dtype=torch.bool, device="cuda")
    rel_k, err_k = row_rel_err(dk, ref[1], kv_rows)
    rel_v, err_v = row_rel_err(dv, ref[2], kv_rows)
    rel, err = max(rel_q, rel_k, rel_v), max(err_q, err_k, err_v)
    if rel > ROW_TOL:
        raise AssertionError(f"flash_bwd {qshape}: row error dq {rel_q} dk {rel_k} dv {rel_v} "
                             f"> {ROW_TOL} of max|ref|")
    del ref
    ms = time_ms(lambda: tatt.flash_attention_bwd(q, k, v, o, lse, do, **kw), reps)
    plain_ms = time_ms(lambda: tatt.flash_attention_bwd_reference(q, k, v, o, lse_ref, do, **kw),
                       max(2, reps // 4))
    rep = h // hkv
    qt = q.detach().transpose(1, 2).requires_grad_()
    kt = k.detach().repeat_interleave(rep, 2).transpose(1, 2).requires_grad_()
    vt = v.detach().repeat_interleave(rep, 2).transpose(1, 2).requires_grad_()
    mask = None if allowed is None else allowed.expand(b, 1, lq, lk)
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale)
    go = do.transpose(1, 2)
    lib_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), go, retain_graph=True), reps)
    desc = (f"B={b} Lq={lq} Lk={lk} H={h}/{hkv} D={d} causal={causal} "
            f"segments={'none' if qseg is None else qseg.unique().numel()}")
    return dict(desc=desc, err=err, rel=rel, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                bound=flash_bwd_bound(b, lq, lk, h, hkv, d, pairs, segs),
                flops=10.0 * h * d * pairs)


def lib_window(q, k, v, window, q_window, scale):
    """Window attention as one SDPA call over the windows (SDPA's math path
    at f32: its other kernels round f32 operands)."""
    import torch.nn.functional as F

    b, lk, h, d = k.shape
    nw = lk // window

    def win(t, n):
        return t.reshape(b * nw, n, h, d).transpose(1, 2)

    with math_sdpa(q):
        out = F.scaled_dot_product_attention(
            win(q, q_window), win(k, window), win(v, window), scale=scale)
    return out.transpose(1, 2).reshape(b, nw * q_window, h, d)


def math_sdpa(x):
    """SDPA limited to its math path for an f32 `x`, else no limit."""
    import contextlib

    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    return sdpa_kernel(SDPBackend.MATH) if x.dtype == torch.float32 else contextlib.nullcontext()


def check_window(key, _extra, gen, reps):
    import torch
    from rga3_tpu_torch.ops.attention import window_attention, window_reference

    shape, qstride, kstride, vstride, w, scale, kshape, qw = key
    b, l, h, d = shape
    q = randn_strided(shape, qstride, gen)
    k = randn_strided(kshape, kstride, gen)
    v = randn_strided(kshape, vstride, gen)
    out = window_attention(q, k, v, w, q_window=qw, scale=scale)
    ref = window_reference(q, k, v, w, scale, q_window=qw)
    if not torch.isfinite(out).all():
        raise AssertionError(f"window {shape}: non-finite output")
    rel, err = row_rel_err(out, ref, torch.ones(b, l, dtype=torch.bool, device="cuda"))
    if rel > ROW_TOL:
        raise AssertionError(f"window {shape}: row error {rel} > {ROW_TOL} of max|ref|")
    ms = time_ms(lambda: window_attention(q, k, v, w, q_window=qw, scale=scale), reps)
    plain_ms = time_ms(lambda: window_reference(q, k, v, w, scale, q_window=qw),
                       max(2, reps // 4))
    lib_ms = time_ms(lambda: lib_window(q, k, v, w, qw, scale), reps)
    flops = 4.0 * b * h * l * w * d
    nbytes = 2.0 * (2 * b * l * h * d + 2 * b * kshape[1] * h * d)
    return dict(desc=f"B={b} Lq={l} Lk={kshape[1]} H={h} D={d} window={w} q_window={qw}",
                err=err, rel=rel, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                bound=bound(flops, nbytes), flops=flops)


# ---- the fused Hiera blocks (ops/fused_block.py) and their three kernels


def rand(shape, gen, scale=1.0):
    import torch

    return (torch.randn(shape, device="cuda", generator=gen) * scale).bfloat16()


def linear_params(n, k, gen):
    return rand((n, k), gen, k ** -0.5), rand((n,), gen, 0.1)


def block_params(c_in, d, f, gen, transition=False):
    p = {"ln1_g": 1 + rand((c_in,), gen, 0.1), "ln1_b": rand((c_in,), gen, 0.1),
         "ln2_g": 1 + rand((d,), gen, 0.1), "ln2_b": rand((d,), gen, 0.1)}
    p["wqkv"], p["bqkv"] = linear_params(3 * d, c_in, gen)
    p["wproj"], p["bproj"] = linear_params(d, c_in, gen)
    if transition:
        p["wattn"], p["battn"] = linear_params(d, d, gen)
    p["w1"], p["b1"] = linear_params(f, d, gen)
    p["w2"], p["b2"] = linear_params(d, f, gen)
    return p


def lib_ln(x, g, b, eps):
    import torch.nn.functional as F

    return F.layer_norm(x, (x.shape[-1],), g, b, eps)


def lib_pool(t, ws):
    import torch.nn.functional as F

    b, l, c = t.shape
    y = F.max_pool2d(t.reshape(-1, ws, ws, c).permute(0, 3, 1, 2), 2)
    return y.permute(0, 2, 3, 1).reshape(b, l // 4, c)


def lib_mlp(y, p, eps, tanh):
    import torch.nn.functional as F

    h = F.linear(lib_ln(y, p["ln2_g"], p["ln2_b"], eps), p["w1"], p["b1"])
    h = F.gelu(h, approximate="tanh" if tanh else "none")
    return y + F.linear(h, p["w2"], p["b2"])


def lib_block(x, p, heads, window, eps, scale, tanh):
    """A windowed (window > 0) or global block of library calls."""
    import torch.nn.functional as F

    b, l, d = x.shape
    qkv = F.linear(lib_ln(x, p["ln1_g"], p["ln1_b"], eps), p["wqkv"], p["bqkv"])
    q, k, v = qkv.view(b, l, 3, heads, -1).unbind(2)
    if window:
        attn = lib_window(q, k, v, window, window, scale)
    else:
        attn = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale
        ).transpose(1, 2)
    y = x + F.linear(attn.reshape(b, l, d), p["wproj"], p["bproj"])
    return lib_mlp(y, p, eps, tanh)


def lib_transition(x, p, heads, ws, eps, scale, tanh):
    import torch.nn.functional as F

    b, l, _ = x.shape
    c = p["wproj"].shape[0]
    ln = lib_ln(x, p["ln1_g"], p["ln1_b"], eps)
    shortcut = lib_pool(F.linear(ln, p["wproj"], p["bproj"]), ws)
    qkv = F.linear(ln, p["wqkv"], p["bqkv"])
    q = lib_pool(qkv[:, :, :c], ws).view(b, l // 4, heads, -1)
    _, k, v = qkv.view(b, l, 3, heads, -1).unbind(2)
    attn = lib_window(q, k, v, ws * ws, ws * ws // 4, scale).reshape(b, l // 4, c)
    return lib_mlp(shortcut + F.linear(attn, p["wattn"], p["battn"]), p, eps, tanh)


def measure(desc, run, plain, lib, flops, nbytes, reps, tol=ROW_TOL, peak=PEAK_BF16_FLOPS):
    """Check `run()` against `plain()` per output row (within `tol` of the
    row's max|plain|), then time all three."""
    import torch

    outs, refs = run(), plain()
    if not isinstance(outs, tuple):
        outs, refs = (outs,), (refs,)
    rel = err = 0.0
    for out, ref in zip(outs, refs):
        if out.shape != ref.shape or not torch.isfinite(out).all():
            raise AssertionError(f"{desc}: output {tuple(out.shape)} non-finite or "
                                 f"not {tuple(ref.shape)}")
        r, e = row_rel_err(out, ref, torch.ones(out.shape[:-1], dtype=torch.bool,
                                                device="cuda"))
        rel, err = max(rel, r), max(err, e)
    if rel > tol:
        raise AssertionError(f"{desc}: row error {rel} > {tol} of max|ref|")
    return dict(desc=desc, err=err, rel=rel, ms=time_ms(run, reps),
                plain_ms=time_ms(plain, max(2, reps // 4)),
                lib_ms=None if lib is None else time_ms(lib, reps),
                bound=bound(flops, nbytes, peak), tol=tol)


def check_gemm(key, _extra, gen, reps):
    import torch.nn.functional as F
    from rga3_tpu_torch.ops import fused_block as fb

    m, n, k, epi = key
    a = rand((m, k), gen)
    w, bias = linear_params(n, k, gen)
    res = rand((m, n), gen) if epi.startswith("res") else None
    kw = dict(epilogue=epi, residual=res)

    def lib():
        h = F.linear(a, w, bias)
        if epi.startswith("gelu"):
            return F.gelu(h, approximate="tanh" if epi == "gelu_tanh" else "none")
        return h if res is None else res + h

    nbytes = 2.0 * (m * k + n * k + m * n * (2 if res is not None else 1))
    r = measure(f"M={m} N={n} K={k} epilogue={epi}", lambda: fb.gemm(a, w, bias, **kw),
                lambda: fb.gemm_reference(a, w, bias, **kw), lib, 2.0 * m * n * k, nbytes, reps)
    r["flops"] = 2.0 * m * n * k
    return r


def check_layer_norm(key, _extra, gen, reps):
    from rga3_tpu_torch.ops import fused_block as fb

    rows, d, eps = key
    x = rand((rows, d), gen)
    g, b = 1 + rand((d,), gen, 0.1), rand((d,), gen, 0.1)
    return measure(f"rows={rows} D={d}", lambda: fb.layer_norm(x, g, b, eps),
                   lambda: fb.layer_norm_reference(x, g, b, eps),
                   lambda: lib_ln(x, g, b, eps), 8.0 * rows * d, 4.0 * rows * d, reps)


def check_pool(key, _extra, gen, reps):
    from rga3_tpu_torch.ops import fused_block as fb

    shape, stride, ws = key
    b, l, c = shape
    x = rand((b, l, stride[1]), gen)[:, :, :c]
    return measure(f"B={b} L={l} C={c} row stride={stride[1]} ws={ws}",
                   lambda: fb.window_pool2x2(x, ws),
                   lambda: fb.window_pool2x2_reference(x, ws),
                   lambda: lib_pool(x, ws), 3.0 * b * l * c / 4, 2.0 * b * l * c * 5 / 4, reps)


def check_ln_qkv(key, _extra, gen, reps):
    import torch.nn.functional as F
    from rga3_tpu_torch.ops import fused_block as fb

    shape, n, eps = key
    b, l, d = shape
    x = rand(shape, gen)
    g, bb = 1 + rand((d,), gen, 0.1), rand((d,), gen, 0.1)
    w, bias = linear_params(n, d, gen)
    t = b * l
    return measure(f"B={b} L={l} D={d} N={n}",
                   lambda: fb.ln_qkv(x, g, bb, w, bias, eps=eps),
                   lambda: fb.ln_qkv_reference(x, g, bb, w, bias, eps=eps),
                   lambda: F.linear(lib_ln(x, g, bb, eps), w, bias),
                   2.0 * t * d * n, 2.0 * (t * d + n * d + t * n), reps)


def check_proj_mlp(key, _extra, gen, reps):
    import torch.nn.functional as F
    from rga3_tpu_torch.ops import fused_block as fb

    shape, f, eps, tanh = key
    b, l, d = shape
    attn, x = rand(shape, gen), rand(shape, gen)
    p = block_params(d, d, f, gen)
    args = (attn, x, p["wproj"], p["bproj"], p["ln2_g"], p["ln2_b"], p["w1"], p["b1"],
            p["w2"], p["b2"])
    t = b * l
    return measure(f"B={b} L={l} D={d} F={f}",
                   lambda: fb.proj_mlp(*args, eps=eps, gelu_tanh=tanh),
                   lambda: fb.proj_mlp_reference(*args, eps=eps, gelu_tanh=tanh),
                   lambda: lib_mlp(x + F.linear(attn, p["wproj"], p["bproj"]), p, eps, tanh),
                   2.0 * t * (d * d + 2 * d * f), 2.0 * (3 * t * d + d * d + 2 * d * f), reps)


def check_proj_ln(key, _extra, gen, reps):
    import torch.nn.functional as F
    from rga3_tpu_torch.ops import fused_block as fb

    shape, eps = key
    b, l, d = shape
    attn, x = rand(shape, gen), rand(shape, gen)
    p = block_params(d, d, 4 * d, gen)
    args = (attn, x, p["wproj"], p["bproj"], p["ln2_g"], p["ln2_b"])

    def lib():
        y = x + F.linear(attn, p["wproj"], p["bproj"])
        return y, lib_ln(y, p["ln2_g"], p["ln2_b"], eps)

    t = b * l
    return measure(f"B={b} L={l} D={d}", lambda: fb.proj_ln(*args, eps=eps),
                   lambda: fb.proj_ln_reference(*args, eps=eps), lib,
                   2.0 * t * d * d, 2.0 * (4 * t * d + d * d), reps)


def check_mlp_blocked(key, _extra, gen, reps):
    import torch.nn.functional as F
    from rga3_tpu_torch.ops import fused_block as fb

    shape, f, tanh = key
    b, l, d = shape
    ln2y, y = rand(shape, gen), rand(shape, gen)
    p = block_params(d, d, f, gen)
    args = (ln2y, y, p["w1"], p["b1"], p["w2"], p["b2"])

    def lib():
        h = F.gelu(F.linear(ln2y, p["w1"], p["b1"]), approximate="tanh" if tanh else "none")
        return y + F.linear(h, p["w2"], p["b2"])

    t = b * l
    return measure(f"B={b} L={l} D={d} F={f}", lambda: fb.mlp_blocked(*args, gelu_tanh=tanh),
                   lambda: fb.mlp_blocked_reference(*args, gelu_tanh=tanh), lib,
                   4.0 * t * d * f, 2.0 * (3 * t * d + 2 * d * f), reps)


def _block_cost(t, d, f, attn_flops):
    flops = 2.0 * t * (4 * d * d + 2 * d * f) + attn_flops
    return flops, 2.0 * (2 * t * d + 4 * d * d + 2 * d * f)


def check_window_block(key, _extra, gen, reps, split=False):
    from rga3_tpu_torch.ops import fused_block as fb

    shape, f, heads, window, eps, scale, tanh = key
    b, l, d = shape
    x = rand(shape, gen)
    p = block_params(d, d, f, gen)
    kw = dict(num_heads=heads, window=window, eps=eps, scale=scale, gelu_tanh=tanh)
    wrapper = fb.fused_window_block_split if split else fb.fused_window_block
    return measure(f"B={b} L={l} D={d} F={f} H={heads} window={window}",
                   lambda: wrapper(x, p, **kw), lambda: fb.reference_block(x, p, split=split, **kw),
                   lambda: lib_block(x, p, heads, window, eps, scale, tanh),
                   *_block_cost(b * l, d, f, 4.0 * b * l * window * d), reps)


def check_split_block(key, extra, gen, reps):
    return check_window_block(key, extra, gen, reps, split=True)


def check_global_block(key, _extra, gen, reps):
    from rga3_tpu_torch.ops import fused_block as fb

    shape, f, heads, eps, scale, tanh = key
    b, l, d = shape
    x = rand(shape, gen)
    p = block_params(d, d, f, gen)
    kw = dict(num_heads=heads, eps=eps, scale=scale, gelu_tanh=tanh)
    return measure(f"B={b} L={l} D={d} F={f} H={heads}",
                   lambda: fb.fused_global_block(x, p, **kw),
                   lambda: fb.reference_global_block(x, p, **kw),
                   lambda: lib_block(x, p, heads, 0, eps, scale, tanh),
                   *_block_cost(b * l, d, f, 4.0 * b * l * l * d), reps)


def check_transition(key, _extra, gen, reps):
    from rga3_tpu_torch.ops import fused_block as fb

    shape, c, f, heads, ws, eps, scale, tanh = key
    b, l, c_in = shape
    x = rand(shape, gen)
    p = block_params(c_in, c, f, gen, transition=True)
    kw = dict(num_heads=heads, ws=ws, eps=eps, scale=scale, gelu_tanh=tanh)
    t_in, t_out = b * l, b * l // 4
    flops = (2.0 * t_in * c_in * 4 * c + 4.0 * t_out * ws * ws * c
             + 2.0 * t_out * (c * c + 2 * c * f))
    nbytes = 2.0 * (t_in * c_in + t_out * c + 4 * c_in * c + c * c + 2 * c * f)
    return measure(f"B={b} L={l} C_in={c_in} C_out={c} F={f} H={heads} ws={ws}",
                   lambda: fb.fused_transition_block(x, p, **kw),
                   lambda: fb.reference_transition(x, p, **kw),
                   lambda: lib_transition(x, p, heads, ws, eps, scale, tanh),
                   flops, nbytes, reps)


# ---- the f32 variants (csrc/f32_ops.cu): each at its recorded calls
# against its f32 plain version, TF32 off since phase 1, within F32_TOL; the
# library time is cuBLAS f32 / SDPA's math path; the GEMM's and the
# attention's bound at the 3xTF32 peak, their share of the CUDA cores' f32
# bound beside it, the row kernels' bound at the f32 peak


def with_cuda_core_share(r, flops, nbytes):
    """`r` of a 3xTF32 kernel with its bound at the CUDA cores' f32 peak."""
    r["flops"] = flops
    r["cuda_core_bound"] = bound(flops, nbytes, PEAK_F32_FLOPS)
    return r


def rand32(shape, gen, scale=1.0):
    import torch

    return torch.randn(shape, device="cuda", generator=gen) * scale


def check_gemm_f32(key, _extra, gen, reps):
    import torch.nn.functional as F
    from rga3_tpu_torch.ops import fused_block as fb

    m, n, k, epi = key
    a = rand32((m, k), gen)
    w, bias = rand32((n, k), gen, k ** -0.5), rand32((n,), gen, 0.1)
    res = rand32((m, n), gen) if epi.startswith("res") else None
    kw = dict(epilogue=epi, residual=res)

    def lib():
        h = F.linear(a, w, bias)
        if epi.startswith("gelu"):
            return F.gelu(h, approximate="tanh" if epi == "gelu_tanh" else "none")
        return h if res is None else res + h

    nbytes = 4.0 * (m * k + n * k + m * n * (2 if res is not None else 1))
    r = measure(f"f32 M={m} N={n} K={k} epilogue={epi}", lambda: fb.gemm_f32(a, w, bias, **kw),
                lambda: fb.gemm_reference(a, w, bias, **kw), lib, 2.0 * m * n * k, nbytes, reps,
                tol=F32_TOL, peak=PEAK_3XTF32_FLOPS)
    return with_cuda_core_share(r, 2.0 * m * n * k, nbytes)


def check_layer_norm_f32(key, _extra, gen, reps):
    from rga3_tpu_torch.ops import fused_block as fb

    rows, d, eps = key
    x = rand32((rows, d), gen)
    g, b = 1 + rand32((d,), gen, 0.1), rand32((d,), gen, 0.1)
    return measure(f"f32 rows={rows} D={d}", lambda: fb.layer_norm_f32(x, g, b, eps),
                   lambda: fb.layer_norm_reference(x, g, b, eps),
                   lambda: lib_ln(x, g, b, eps), 8.0 * rows * d, 8.0 * rows * d, reps,
                   tol=F32_TOL, peak=PEAK_F32_FLOPS)


def check_pool_f32(key, _extra, gen, reps):
    from rga3_tpu_torch.ops import fused_block as fb

    shape, stride, ws = key
    b, l, c = shape
    x = rand32((b, l, stride[1]), gen)[:, :, :c]
    return measure(f"f32 B={b} L={l} C={c} row stride={stride[1]} ws={ws}",
                   lambda: fb.window_pool2x2_f32(x, ws),
                   lambda: fb.window_pool2x2_reference(x, ws),
                   lambda: lib_pool(x, ws), 3.0 * b * l * c / 4, 4.0 * b * l * c * 5 / 4, reps,
                   tol=F32_TOL, peak=PEAK_F32_FLOPS)


def check_window_f32(key, _extra, gen, reps):
    import torch
    from rga3_tpu_torch.ops.attention import window_attention_f32, window_reference

    shape, qstride, kstride, vstride, w, scale, kshape, qw = key
    b, l, h, d = shape
    q = randn_strided(shape, qstride, gen, torch.float32)
    k = randn_strided(kshape, kstride, gen, torch.float32)
    v = randn_strided(kshape, vstride, gen, torch.float32)
    flops = 4.0 * b * h * l * w * d
    nbytes = 4.0 * (2 * b * l * h * d + 2 * b * kshape[1] * h * d)
    r = measure(f"f32 B={b} Lq={l} Lk={kshape[1]} H={h} D={d} window={w} q_window={qw}",
                lambda: window_attention_f32(q, k, v, w, q_window=qw, scale=scale),
                lambda: window_reference(q, k, v, w, scale, q_window=qw),
                lambda: lib_window(q, k, v, w, qw, scale), flops, nbytes, reps,
                tol=F32_TOL, peak=PEAK_3XTF32_FLOPS)
    return with_cuda_core_share(r, flops, nbytes)


def check_flash_f32(key, _extra, gen, reps):
    import torch
    import torch.nn.functional as F
    from rga3_tpu_torch.ops.attention import flash_attention_f32

    qshape, qstride, kshape, kstride, vstride, causal, scale = key
    b, lq, h, d = qshape
    lk = kshape[1]
    q = randn_strided(qshape, qstride, gen, torch.float32)
    k = randn_strided(kshape, kstride, gen, torch.float32)
    v = randn_strided(kshape, vstride, gen, torch.float32)
    kw = dict(causal=False, segment_ids=None, kv_segment_ids=None, scale=scale)

    def lib():
        with math_sdpa(q):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale
            ).transpose(1, 2)

    flops = 4.0 * b * h * lq * lk * d
    nbytes = 4.0 * (2 * b * lq * h * d + 2 * b * lk * h * d)
    r = measure(f"f32 B={b} Lq={lq} Lk={lk} H={h} D={d}",
                lambda: flash_attention_f32(q, k, v, scale=scale),
                lambda: plain_flash(q, k, v, kw), lib, flops, nbytes, reps,
                tol=F32_TOL, peak=PEAK_3XTF32_FLOPS)
    return with_cuda_core_share(r, flops, nbytes)


def time_graph(make_fn, copies, reps):
    """Device ms per call of `make_fn(copy)`, cycling over `copies` (so that
    each call reads operands the previous calls pushed out of the L2
    cache), from replays of a CUDA graph of the calls: launched one by one,
    a call costs the host tens of µs, more than a decode-shaped kernel runs,
    and the events would time the host."""
    import torch

    n = len(copies) * -(-reps // len(copies))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        for c in copies:
            make_fn(c)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in itertools.islice(itertools.cycle(copies), n):
            make_fn(c)
    ms = time_ms(graph.replay, 3) / n
    del graph
    return ms


def check_int4(key, _extra, gen, reps):
    import torch
    import torch.nn.functional as F
    from rga3_tpu_torch.ops import quant as tq

    m, in_dim, out = key
    q, s = tq.quantize_int4(rand((in_dim, out), gen, 0.02))
    x = rand((m, in_dim), gen)
    y, ref = tq.int4_matmul(x, q, s), tq.int4_matmul_reference(x, q, s)
    if y.shape != ref.shape or not torch.isfinite(y).all():
        raise AssertionError(f"int4_matmul {key}: output non-finite or of the wrong shape")
    # the split sum runs in a fixed order: a second launch gives equal bits
    if not torch.equal(y, tq.int4_matmul(x, q, s)):
        raise AssertionError(f"int4_matmul {key}: two launches differ")
    rel, err = row_rel_err(y, ref, torch.ones(m, dtype=torch.bool, device="cuda"))
    if rel > ROW_TOL:
        raise AssertionError(f"int4_matmul {key}: row error {rel} > {ROW_TOL} of max|ref|")
    wbytes = q.numel() + 4 * s.numel()
    copies = [(q, s)] + [(q.clone(), s.clone())
                         for _ in range(min(63, int(L2_ROTATE_BYTES // wbytes)))]
    ms = time_graph(lambda qs: tq.int4_matmul(x, *qs), copies, reps)
    plain_ms = time_graph(lambda qs: tq.int4_matmul_reference(x, *qs), copies[:1],
                          max(2, reps // 4))
    del copies
    wd = tq.dequantize_int4(q, s).t().contiguous().bfloat16()
    lib_copies = [wd] + [wd.clone() for _ in range(min(15, int(L2_ROTATE_BYTES // (2 * wd.numel()))))]
    lib_ms = time_graph(lambda w: F.linear(x, w), lib_copies, reps)
    del lib_copies, wd
    nbytes = 2.0 * m * in_dim + wbytes + 2.0 * m * out
    flops = 2.0 * m * in_dim * out
    return dict(desc=f"M={m} in={in_dim} out={out} splits {tq.int4_splits(m, in_dim, out)}",
                err=err, rel=rel, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                bound=bound(flops, nbytes), flops=flops)


# name, check, source, the TPU kernel it replaces
FUSED = "rga3_tpu/ops/fused_block.py"
KERNELS = (
    ("flash_attention", check_flash, "rga3_tpu_torch/csrc/flash_attention.cu",
     "rga3_tpu/ops/attention.py:75"),
    ("flash_attention_bwd", check_flash_bwd, "rga3_tpu_torch/csrc/flash_attention_bwd.cu",
     "rga3_tpu/ops/attention.py:480"),
    ("window_attention", check_window, "rga3_tpu_torch/csrc/window_attention.cu",
     "rga3_tpu/ops/attention.py:228"),
    ("gemm", check_gemm, "rga3_tpu_torch/csrc/gemm.cu", f"{FUSED}:312"),
    ("layer_norm", check_layer_norm, "rga3_tpu_torch/csrc/row_ops.cu", f"{FUSED}:543"),
    ("window_pool2x2", check_pool, "rga3_tpu_torch/csrc/row_ops.cu", f"{FUSED}:907"),
    ("ln_qkv", check_ln_qkv, "rga3_tpu_torch/ops/fused_block.py", f"{FUSED}:312"),
    ("proj_mlp", check_proj_mlp, "rga3_tpu_torch/ops/fused_block.py", f"{FUSED}:324"),
    ("proj_ln", check_proj_ln, "rga3_tpu_torch/ops/fused_block.py", f"{FUSED}:543"),
    ("mlp_blocked", check_mlp_blocked, "rga3_tpu_torch/ops/fused_block.py", f"{FUSED}:583"),
    ("fused_window_block", check_window_block, "rga3_tpu_torch/ops/fused_block.py",
     f"{FUSED}:105"),
    ("fused_global_block", check_global_block, "rga3_tpu_torch/ops/fused_block.py",
     f"{FUSED}:481"),
    ("fused_window_block_split", check_split_block, "rga3_tpu_torch/ops/fused_block.py",
     f"{FUSED}:694"),
    ("fused_transition_block", check_transition, "rga3_tpu_torch/ops/fused_block.py",
     f"{FUSED}:917"),
    ("int4_matmul", check_int4, "rga3_tpu_torch/csrc/int4_matmul.cu",
     "rga3_tpu/ops/quant.py:159"),
    # the f32 variants: the encoder and the SAM2 decoder's attention under
    # f32 parameters (phase 6b's train entry point)
    ("gemm_f32", check_gemm_f32, "rga3_tpu_torch/csrc/f32_ops.cu", f"{FUSED}:312"),
    ("layer_norm_f32", check_layer_norm_f32, "rga3_tpu_torch/csrc/f32_ops.cu", f"{FUSED}:543"),
    ("window_pool2x2_f32", check_pool_f32, "rga3_tpu_torch/csrc/f32_ops.cu", f"{FUSED}:907"),
    ("window_attention_f32", check_window_f32, "rga3_tpu_torch/csrc/f32_ops.cu",
     "rga3_tpu/ops/attention.py:228"),
    ("flash_attention_f32", check_flash_f32, "rga3_tpu_torch/csrc/f32_ops.cu",
     "rga3_tpu/ops/attention.py:75"),
)
F32_KERNELS = ("gemm_f32", "layer_norm_f32", "window_pool2x2_f32", "window_attention_f32",
               "flash_attention_f32")
SEGMENT_KERNELS = tuple(name for name, *_ in KERNELS
                        if name not in ("int4_matmul", "flash_attention_bwd") + F32_KERNELS)
# the training path runs every kernel of segmentation and the backward
TRAIN_KERNELS = SEGMENT_KERNELS + ("flash_attention_bwd",)
# launches of the fused block wrappers in one 8-frame call: Hiera-L's
# windowed blocks at widths <= 576 (stages 1-3: 2 + 5 + 32), its global
# blocks (23, 33, 43), its stage-4 windowed blocks and its q-pool blocks
# (2, 8, 44); rows 4-7 on their own in the global and split blocks only (the
# window and transition blocks chain the kernels directly, as the Pallas
# kernels are one each); per block two LayerNorms and four products (five
# in a transition)
HIERA_L_LAUNCHES = {"fused_window_block": 39, "fused_global_block": 3,
                    "fused_window_block_split": 3, "fused_transition_block": 3,
                    "ln_qkv": 6, "proj_mlp": 3, "proj_ln": 3, "mlp_blocked": 3,
                    "gemm": 4 * 45 + 5 * 3, "layer_norm": 2 * 48, "window_pool2x2": 2 * 3}
# the same blocks in f32 (under f32 parameters), counted by the f32 kernels:
# a window attention in each windowed and transition block, a flash forward
# in each global block
HIERA_L_F32_LAUNCHES = {"gemm_f32": 4 * 45 + 5 * 3, "layer_norm_f32": 2 * 48,
                        "window_pool2x2_f32": 2 * 3, "window_attention_f32": 39 + 3 + 3,
                        "flash_attention_f32": 3}


# --------------------------------------------------------------------------
# the segmentation benchmark drivers through their CLIs at full width
# --------------------------------------------------------------------------


def _tree_state(root: str) -> dict:
    """{relative path: (size, mtime_ns)} of every file under root."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            st = os.stat(os.path.join(d, n))
            out[os.path.relpath(os.path.join(d, n), root)] = (st.st_size, st.st_mtime_ns)
    return out


def _files_equal(a: str, b: str, names) -> bool:
    for rel in names:
        with open(os.path.join(a, rel), "rb") as fa, open(os.path.join(b, rel), "rb") as fb:
            if fa.read() != fb.read():
                return False
    return True


def _jf_of(args):
    """(J, F) means of one expression's (T, H, W) ground truth and masks."""
    import numpy as np
    from rga3_tpu_torch.evaluation.jf_metrics import db_eval_boundary, db_eval_iou

    gt, pred = args
    return float(np.mean(db_eval_iou(gt, pred))), float(np.mean(db_eval_boundary(gt, pred)))


def eval_phase(seed: int, card_line: str, read_path) -> dict:
    """Phase 3b: the referring-VOS driver (`python -m
    rga3_tpu_torch.evaluation.eval_vos`, called in-process through `main`)
    on a synthetic MeViS tree of EVAL_FRAMES frames at EVAL_SIZE with
    EVAL_EXPRESSIONS expressions, at Qwen2.5-VL-7B + Hiera-L (bf16, random
    weights from the seed, built by the CLI): infer cold (launches counted)
    and warm into a fresh tree (byte-identical), traced into a third; the
    PNGs equal to a direct `segment_video_multi` of the frames read back,
    bit for bit; a resume that writes nothing; the eval stage's
    jf_scores.json equal to the J&F of the direct masks computed here; then
    the image driver (`eval_img`, ReasonSeg layout, EVAL_IMAGES images) on
    the same weights, its gIoU / cIoU equal to a recomputation from direct
    `segment_video` calls. Works under build/eval_phase/."""
    import glob
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from PIL import Image
    from rga3_tpu_torch.data.datasets.image_seg import get_mask_from_json
    from rga3_tpu_torch.data.video import load_frames_from_dir
    from rga3_tpu_torch.evaluation import eval_img, eval_vos
    from rga3_tpu_torch.evaluation.image_seg_eval import evaluate_image_masks
    from rga3_tpu_torch.evaluation.segmentor import UniGRSegmentor, eval_seg_question
    from rga3_tpu_torch.evaluation.video_seg_eval import load_meta_expressions, resolve_layout
    from rga3_tpu_torch.ops.attention import reset_launches
    from rga3_tpu_torch.tools.synth_trees import write_reason_seg_tree, write_vos_tree
    from rga3_tpu_torch.utils import rle

    work = os.path.join(HERE, "build", "eval_phase")
    shutil.rmtree(work, ignore_errors=True)
    paths = {}
    t0 = time.perf_counter()
    tree = write_vos_tree(os.path.join(work, "mevis"), "mevis", split="valid_u", seed=seed,
                          n_frames=EVAL_FRAMES, size=EVAL_SIZE, n_objects=4,
                          n_expressions=EVAL_EXPRESSIONS)
    log(f"eval: MeViS-layout tree, 1 video of {EVAL_FRAMES} frames at {EVAL_SIZE[0]}x"
        f"{EVAL_SIZE[1]}, {EVAL_EXPRESSIONS} expressions, written in "
        f"{time.perf_counter() - t0:.2f} s")
    data = ["--benchmark", "mevis", "--data_root", tree["data_root"], "--split", "valid_u"]
    flags = ["--model_dir", "dummy", "--model_size", "7b", "--seed", str(seed)]

    def infer(out, model=None):
        t = time.perf_counter()
        res = eval_vos.main(["--stage", "infer", *data, "--out_dir", os.path.join(work, out),
                             *flags], model=model)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    # cold: the CLI builds the model; the launches of this call are the path's
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    cold, cold_wall = infer("out_cold")
    launches, calls = read_path()
    paths["eval_vos"] = (launches, calls)
    seg = cold["segmentor"]
    model = (seg.model, seg.processor)
    chunks = math.ceil(EVAL_FRAMES / seg.sam_chunk)
    n_png = EVAL_FRAMES * EVAL_EXPRESSIONS
    log(f"eval: infer cold {cold_wall:.3f} s with the model build, {cold['seconds']['total']:.3f} "
        f"s of run_inference; {card_line}")
    log("eval: infer cold host seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in cold["seconds"].items()) + "; segmentor phases: " + ", ".join(
        f"{k} {v:.3f}" for k, v in seg.phase_seconds.items()) + f"; {card_line}")
    log(f"eval: launches of the cold infer: {launches}")
    if cold["n"] != EVAL_EXPRESSIONS:
        raise AssertionError(f"eval: cold infer wrote {cold['n']} expressions")
    for k in SEGMENT_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"eval: {k} was not launched by the VOS driver")
    for k, n in HIERA_L_LAUNCHES.items():
        if launches[k] != n * chunks:
            raise AssertionError(f"eval: {k}: {launches[k]} launches, {chunks} chunks of "
                                 f"Hiera-L make {n * chunks}")
    cold_tree = _tree_state(os.path.join(work, "out_cold"))
    if len(cold_tree) != n_png:
        raise AssertionError(f"eval: {len(cold_tree)} PNGs, expected {n_png}")

    # warm, into a fresh tree: the same bytes
    warm, warm_wall = infer("out_warm", model)
    log(f"eval: infer warm {warm_wall:.3f} s, {warm_wall / EVAL_EXPRESSIONS:.3f} s an "
        f"expression, {warm_wall / n_png * 1e3:.2f} ms a mask frame; host seconds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in warm["seconds"].items())
        + "; segmentor phases: " + ", ".join(
            f"{k} {v:.3f}" for k, v in warm["segmentor"].phase_seconds.items())
        + f"; {card_line}")
    log(f"eval: PNG writing {warm['seconds']['write_png']:.3f} s for {n_png} masks "
        f"({warm['seconds']['write_png'] / n_png * 1e3:.2f} ms each); {card_line}")
    log(f"eval: peak memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(the phase-3 model and the CLI's); {card_line}")
    if set(_tree_state(os.path.join(work, "out_warm"))) != set(cold_tree) or not _files_equal(
            os.path.join(work, "out_cold"), os.path.join(work, "out_warm"), cold_tree):
        raise AssertionError("eval: the warm infer's PNG tree differs from the cold one's")

    # the device's busy share of a warm infer, traced into a third tree
    busy = device_breakdown(lambda: infer("out_traced", model))
    log(f"profile: eval infer device busy in the traced call / wall of the untraced warm "
        f"call: {busy:.1f} / {warm_wall * 1e3:.1f} ms = {busy / (warm_wall * 1e3):.3f}; "
        f"{card_line}")

    # the PNGs against a direct segment_video_multi of the frames read back
    ann, frames_root = resolve_layout(tree["data_root"], "valid_u", "mevis")
    jobs = load_meta_expressions(ann)
    frames = load_frames_from_dir(os.path.join(frames_root, jobs[0]["frames_dir"]))
    direct = UniGRSegmentor(*model, num_frames_mllm=8).segment_video_multi(
        frames, [j["exp"] for j in jobs],
        questions=[eval_seg_question(j["exp"], "mevis", is_sent=j["is_sent"]) for j in jobs])
    bad = 0
    for e, job in enumerate(jobs):
        for i, name in enumerate(job["frames"]):
            png = np.asarray(Image.open(os.path.join(
                work, "out_cold", job["video"], job["exp_id"], f"{name}.png")))
            bad += int(not np.array_equal(png, direct[e, i].astype(np.uint8) * 255))
    log(f"eval: {n_png} PNGs against the direct segment_video_multi masks: {bad} differ; "
        f"foreground {direct.mean():.4f}")
    if bad:
        raise AssertionError(f"eval: {bad} PNGs differ from the direct masks")

    # resume: a second infer into the finished tree writes nothing
    again, _ = infer("out_cold", model)
    if again["n"] != 0 or _tree_state(os.path.join(work, "out_cold")) != cold_tree:
        raise AssertionError(f"eval: the resumed infer wrote {again['n']} expressions")

    # the eval stage (spawned workers) against J&F computed here
    t = time.perf_counter()
    scores = eval_vos.main(["--stage", "eval", *data, "--out_dir",
                            os.path.join(work, "out_cold"), "--num_workers", str(EVAL_WORKERS)])
    eval_s = time.perf_counter() - t
    with open(os.path.join(work, "out_cold", "jf_scores.json")) as f:
        written = json.load(f)
    with open(os.path.join(tree["data_root"], "valid_u", "mask_dict.json")) as f:
        mask_dict = json.load(f)
    gts = []
    for job in jobs:
        gt = np.zeros(direct.shape[1:], bool)
        for aid in job["anno_id"]:
            for i, a in enumerate(mask_dict[aid]):
                gt[i] |= rle.decode(a).astype(bool)
        gts.append(gt)
    t = time.perf_counter()
    with ThreadPoolExecutor(EVAL_WORKERS) as ex:
        jf = list(ex.map(_jf_of, zip(gts, direct)))
    here_s = time.perf_counter() - t
    js = np.asarray([x[0] for x in jf])
    fs = np.asarray([x[1] for x in jf])
    expect = {"J": float(js.mean()), "F": float(fs.mean()),
              "J&F": float((js.mean() + fs.mean()) / 2), "n": len(jf)}
    log(f"eval: eval stage {eval_s:.3f} s with {EVAL_WORKERS} spawned workers "
        f"({n_png} frames at {EVAL_SIZE[0]}x{EVAL_SIZE[1]}); the same J&F here in "
        f"{here_s:.3f} s on {EVAL_WORKERS} threads; jf_scores.json {written}; {card_line}")
    if written != expect or scores != expect:
        raise AssertionError(f"eval: jf_scores.json {written}, computed here {expect}")

    # the image driver on the same weights
    rs_dir = write_reason_seg_tree(os.path.join(work, "data"), "val", seed=seed,
                                   n_images=EVAL_IMAGES, size=EVAL_IMAGE_SIZE)
    reset_launches()
    t = time.perf_counter()
    img_scores = eval_img.main(["--data_root", os.path.join(work, "data"), "--datasets",
                                "ReasonSeg:val", "--out", os.path.join(work, "img_scores.json"),
                                *flags], model=model)
    torch.cuda.synchronize()
    img_s = time.perf_counter() - t
    paths["eval_img"] = read_path()
    img_seg = UniGRSegmentor(*model, num_frames_mllm=1)
    preds, gts = [], []
    for path in sorted(glob.glob(os.path.join(rs_dir, "*.jpg"))):
        img = np.asarray(Image.open(path).convert("RGB"))
        gt, comments, _ = get_mask_from_json(path.replace(".jpg", ".json"), *img.shape[:2])
        preds.append(img_seg.segment_video([img], comments[0])[0])
        gts.append(gt)
    expect = {"ReasonSeg|val": evaluate_image_masks(preds, gts)}
    log(f"eval: image driver {img_s:.3f} s for {EVAL_IMAGES} images at {EVAL_IMAGE_SIZE[0]}x"
        f"{EVAL_IMAGE_SIZE[1]} (cold), {img_s / EVAL_IMAGES:.3f} s an image; scores "
        f"{img_scores}; {card_line}")
    if img_scores != expect:
        raise AssertionError(f"eval: image scores {img_scores}, recomputed {expect}")
    for k in SEGMENT_KERNELS:
        if paths["eval_img"][0][k] <= 0:
            raise AssertionError(f"eval: {k} was not launched by the image driver")
    del cold, warm, again, seg, model, img_seg
    torch.cuda.empty_cache()
    return paths


# --------------------------------------------------------------------------
# the SAM2 memory tracker at Hiera-L width
# --------------------------------------------------------------------------


def d256_launches(calls) -> int:
    """Launches of the flash forward at head dim 256 among recorded calls."""
    return sum(n for key, (n, _) in calls.items() if key[0][3] == 256)


def tracker_phase(model, proc, frames, expressions, read_path) -> dict:
    """`track_video` on the smoke's 8 frames, resized on the card to the
    SAM resolution as `UniGRSegmentor.encode_frames` does: O = 2 objects
    prompted by the expressions' [SEG] embeddings (cold, warm, traced),
    then by one positive click each; each path's launches read after its
    cold call. Checks shapes, finite values, TRACK_D256 flash launches at
    head dim 256 per track, and the kernel route against the plain route
    on frame 1, the first frame that reads memory (frames 2-7 logged).
    Returns the two paths' (launches, calls)."""
    import numpy as np
    import torch
    from rga3_tpu_torch.evaluation.segmentor import UniGRSegmentor
    from rga3_tpu_torch.models.sam2.video import track_video
    from rga3_tpu_torch.ops.attention import reset_launches, set_plain_attention
    from rga3_tpu_torch.ops.resize import resize_u8_bicubic_aa

    sam = model.grounding_encoder
    cfg = sam.cfg
    size = cfg.image_size
    seg = UniGRSegmentor(model, proc, num_frames_mllm=8, sam_chunk=8)
    embs = torch.stack([seg._seg_embedding(frames, e)[0] for e in expressions])[:, None]
    dev = model.device
    u8 = resize_u8_bicubic_aa(torch.as_tensor(np.stack(frames), device=dev), (size, size))
    n_obj, t = embs.shape[0], u8.shape[0]
    paths = {}

    def track(**prompts):
        t1 = time.perf_counter()
        out = track_video(sam, u8, **prompts)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t1

    def check(name, out, launches, calls):
        masks, ptrs = out["high_res_masks"], out["obj_ptrs"]
        n256 = d256_launches(calls["flash_attention"])
        log(f"tracker {name}: masks {tuple(masks.shape)} {masks.dtype}, obj_ptrs "
            f"{tuple(ptrs.shape)}, foreground {(masks > 0).float().mean().item():.4f}; "
            f"flash launches at D=256 {n256} (expected {TRACK_D256}); launches "
            f"{ {k: n for k, n in launches.items() if n} }")
        if masks.shape != (t, n_obj, size, size) or ptrs.shape != (t, n_obj, cfg.hidden_dim):
            raise AssertionError(f"tracker {name}: shapes {masks.shape} {ptrs.shape}")
        if not (torch.isfinite(masks).all() and torch.isfinite(ptrs).all()):
            raise AssertionError(f"tracker {name}: non-finite outputs")
        if n256 != TRACK_D256:
            raise AssertionError(f"tracker {name}: {n256} flash launches at D=256, "
                                 f"expected {TRACK_D256}")
        for k in SEGMENT_KERNELS:
            if launches[k] <= 0:
                raise AssertionError(f"tracker {name}: {k} was not launched")

    lang = dict(language_embd=embs)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out, cold = track(**lang)
    paths["track_language"] = read_path()
    peak = torch.cuda.max_memory_allocated()
    check("language (O=2 [SEG] embeddings)", out, *paths["track_language"])
    _, warm = track(**lang)
    log(f"tracker language: cold {cold:.3f} s, warm {warm:.3f} s per {t}-frame track of "
        f"{n_obj} objects, {t / warm:.2f} frames/s warm; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB (the bf16 UniGR included)")
    busy = device_breakdown(lambda: track_video(sam, u8, **lang))
    log(f"profile (track_video, language): device busy in the traced call / wall of the "
        f"untraced warm call: {busy:.1f} / {warm * 1e3:.1f} ms = {busy / (warm * 1e3):.3f}")
    # one positive click each, at two places of the SAM image
    points = dict(point_coords=torch.tensor([[[0.3 * size, 0.4 * size]],
                                             [[0.7 * size, 0.6 * size]]], device=dev),
                  point_labels=torch.ones(2, 1, dtype=torch.int32, device=dev))
    reset_launches()
    out_p, cold_p = track(**points)
    paths["track_points"] = read_path()
    check("points (one positive click each)", out_p, *paths["track_points"])
    log(f"tracker points: cold {cold_p:.3f} s per track")

    # the plain route (memory attention dense, every kernel call site plain)
    set_plain_attention(sam, True)
    try:
        plain, plain_s = track(**lang)
    finally:
        set_plain_attention(sam, False)
    for f in range(t):
        mk, mp = out["high_res_masks"][f], plain["high_res_masks"][f]
        pk, pp = out["obj_ptrs"][f].float(), plain["obj_ptrs"][f].float()
        agree = ((mk > 0) == (mp > 0)).float().mean().item()
        logit_rel = ((mk - mp).abs().max() / mp.abs().max()).item()
        ptr_rel = ((pk - pp).norm() / pp.norm()).item()
        log(f"tracker kernel vs plain route, frame {f}: mask agreement {agree:.5f}, mask "
            f"logits max err / max|logit| {logit_rel:.3e}, obj_ptrs rel err {ptr_rel:.3e}"
            + (" (gated)" if f == 1 else ""))
        if f == 1 and not (agree > 0.95 and ptr_rel < 0.1):
            raise AssertionError("tracker: the kernel route disagrees with the plain route "
                                 "on frame 1")
    log(f"tracker plain route: {plain_s:.3f} s per track")
    del seg, out, out_p, plain, u8
    torch.cuda.empty_cache()
    return paths


# --------------------------------------------------------------------------
# the legacy UniGR (SAM-v1 ViT-H) and the main path's switches
# --------------------------------------------------------------------------

def legacy_phase(model, proc, frames, expressions, seed, card_line, read_path) -> dict:
    """Phase 5c: `UniGRLegacy` (SAM-v1 ViT-H at 1024^2, random from the seed)
    sharing phase 3's Qwen2.5-VL-7B and its weights: `segment_video_multi`
    on the video's 2 expressions cold (its launches counted: the flash
    forward, no Hiera wrapper) and warm, masks of the video's size and
    finite mask logits; then one `train_forward` + backward on phase 6's
    batch (the release trainable set): a finite loss and the flash backward
    once per LM layer and decoder image->token attention. Seconds and peak
    memory. Returns the two paths."""
    import torch
    from rga3_tpu_torch.evaluation.segmentor import UniGRSegmentor
    from rga3_tpu_torch.models.sam1 import SAM1_VIT_H
    from rga3_tpu_torch.models.unigr.legacy import UniGRLegacy, UniGRLegacyConfig
    from rga3_tpu_torch.ops.attention import reset_launches
    from rga3_tpu_torch.train.optimizer import trainable_mask

    cfg = UniGRLegacyConfig(qwen=model.cfg.qwen, sam1=SAM1_VIT_H, seg=model.cfg.seg)
    t0 = time.perf_counter()
    legacy = UniGRLegacy(cfg, device=model.device, dtype=model.dtype, qwen=model.qwen)
    legacy.init_weights(torch.Generator(model.device.type).manual_seed(seed), qwen=False)
    legacy.eval()
    torch.cuda.synchronize()
    n_sam = sum(p.numel() for p in legacy.sam_model.parameters())
    log(f"legacy: UniGRLegacy (Qwen2.5-VL-7B shared with phase 3 + SAM-v1 ViT-H, "
        f"{n_sam / 1e6:.1f} M params, random from the seed) built in "
        f"{time.perf_counter() - t0:.2f} s")
    seg = UniGRSegmentor(legacy, proc, num_frames_mllm=8, sam_chunk=8)
    paths = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    masks = seg.segment_video_multi(frames, expressions)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    paths["legacy_segment"] = read_path()
    launches = paths["legacy_segment"][0]
    peak = torch.cuda.max_memory_allocated()
    for k in seg.phase_seconds:
        seg.phase_seconds[k] = 0.0
    t0 = time.perf_counter()
    seg.segment_video_multi(frames, expressions)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    phases = dict(seg.phase_seconds)
    emb, has = seg._seg_embedding(frames, expressions[0])
    logits = seg.decode_logits(seg.encode_frames(frames), emb)
    log(f"legacy segment_video_multi: cold {cold:.3f} s, warm {warm:.3f} s (its phases (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
        + f"); masks {masks.shape}, foreground {masks.mean():.4f}; low-res logits "
        f"{tuple(logits.shape)}; launches { {k: n for k, n in launches.items() if n} }; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; {card_line}")
    h, w = frames[0].shape[:2]
    if masks.shape != (len(expressions), len(frames), h, w) or not has:
        raise AssertionError(f"legacy: masks {masks.shape}, has_seg {has}")
    if not torch.isfinite(logits).all():
        raise AssertionError("legacy: non-finite mask logits")
    # the Hiera wrappers: every kernel of segmentation but the flash forward
    if launches["flash_attention"] <= 0 or any(
            launches[k] for k in SEGMENT_KERNELS if k != "flash_attention"):
        raise AssertionError(f"legacy: launches {launches}: the flash forward and no Hiera "
                             "wrapper expected")

    batch = train_batch(frames, model.cfg, seed, legacy.device)
    trainable_mask(legacy)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = legacy.train_forward(**batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out["loss"].backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    paths["legacy_train"] = read_path()
    launches = paths["legacy_train"][0]
    per_step = cfg.qwen.text.num_hidden_layers + cfg.sam1.twoway_depth
    grads = [p.grad for p in legacy.parameters() if p.requires_grad]
    log(f"legacy train_forward + backward (B=2, T={TRAIN_SAM_FRAMES} SAM-v1 frames): forward "
        f"{t1 - t0:.3f} s, backward {t2 - t1:.3f} s; "
        + ", ".join(f"{k} {v.item():.5f}" for k, v in out.items())
        + f"; flash_attention_bwd {launches['flash_attention_bwd']} (the LM's "
        f"{cfg.qwen.text.num_hidden_layers} layers + the decoder's {cfg.sam1.twoway_depth} "
        f"image->token attentions = {per_step}); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card_line}")
    if not all(math.isfinite(v.item()) for v in out.values()):
        raise AssertionError(f"legacy train: non-finite losses {out}")
    if launches["flash_attention_bwd"] != per_step:
        raise AssertionError(f"legacy train: {launches['flash_attention_bwd']} flash backward "
                             f"launches, expected {per_step}")
    if not grads or any(g is None or not torch.isfinite(g).all() for g in grads):
        raise AssertionError("legacy train: a trainable tensor lacks a finite gradient")
    for p in legacy.parameters():
        p.grad = None
    del seg, legacy, batch, out, grads, logits
    torch.cuda.empty_cache()
    return paths


def switches_phase(model, proc, frames, expressions, masks, card_line, read_path) -> dict:
    """Phase 5d: the main path's switches on phase 3's weights, each against
    its default route (see the module docstring). `masks` are phase 3's.
    Returns the paths of the resident tower, the exact GELU and the device
    preprocessing."""
    import numpy as np
    import torch
    from rga3_tpu_torch.evaluation.segmentor import UniGRSegmentor, build_seg_messages
    from rga3_tpu_torch.data.templates import get_sparse_indices
    from rga3_tpu_torch.models.qwen25vl.vision import (
        _take_fill, compute_vision_layout, layout_device_args,
    )
    from rga3_tpu_torch.ops.attention import reset_launches, set_plain_attention

    paths = {}
    seg = UniGRSegmentor(model, proc, num_frames_mllm=8, sam_chunk=8)
    sam = model.grounding_encoder

    # the vision tower with its tokens window-resident against the default
    # route: each block on the resident route's own input (whose pad slots
    # carry what the earlier blocks wrote there) against the default block
    # on that input unpadded, per row; the tower end to end in f32 with
    # every attention plain (the two routes compute one function), and in
    # bf16 within RESIDENT_SPREADS times the default route's own bf16-vs-f32
    # spread
    visual = model.qwen.visual
    idx = get_sparse_indices(len(frames), 8)
    enc = proc(build_seg_messages(expressions[0]), videos=[[frames[i] for i in idx]],
               add_generation_prompt=False)
    vcfg = visual.cfg
    layout = layout_device_args(compute_vision_layout(enc["video_grid_thw"], vcfg), vcfg)
    pixels = torch.as_tensor(enc["pixel_values_videos"], device=model.device)
    blocks = [getattr(visual, f"blocks_{i}") for i in range(vcfg.depth)]
    seen = {"default": [], "resident": []}
    mode = ["default"]
    hooks = [b.register_forward_hook(lambda m, a, kw, out: seen[mode[0]].append((a, kw, out)),
                                     with_kwargs=True) for b in blocks]
    try:
        with torch.no_grad():
            default = visual(pixels, layout)
            mode[0] = "resident"
            visual.cfg = vcfg.replace(window_resident=True)
            reset_launches()
            resident = visual(pixels, layout)
            torch.cuda.synchronize()
            paths["switch_window_resident"] = read_path()
    finally:
        visual.cfg = vcfg
        for h in hooks:
            h.remove()
    win_pad, win_unpad = seen["resident"][0][0][4:6]
    block_rel = []
    with torch.no_grad():
        for block, (dargs, dkw, _), (rargs, _, rout) in zip(blocks, seen["default"],
                                                            seen["resident"]):
            y = block(_take_fill(rargs[0], win_unpad), *dargs[1:], use_full=dkw["use_full"])
            every = torch.ones(1, y.shape[0], dtype=torch.bool, device=y.device)
            block_rel.append(row_rel_err(_take_fill(rout, win_unpad)[None], y[None], every)[0])
        pads = seen["resident"][-1][0][0][win_pad < 0].float().abs().sum().item()
        f32 = copy.deepcopy(visual).float()
        set_plain_attention(f32, True)
        ref32 = f32(pixels, layout)
        f32.cfg = vcfg.replace(window_resident=True)
        res32 = f32(pixels, layout)
    del f32, seen
    rows = torch.ones(1, default.shape[0], dtype=torch.bool, device=default.device)
    rel, err = row_rel_err(resident[None], default[None], rows)
    rel32 = row_rel_err(res32[None], ref32[None], rows)[0]
    spread = row_rel_err(default[None], ref32[None], rows)[0]
    rel_res = row_rel_err(resident[None], ref32[None], rows)[0]
    n_flash = paths["switch_window_resident"][0]["flash_attention"]
    worst = max(range(len(block_rel)), key=block_rel.__getitem__)
    log(f"switch window_resident: each block on the resident route's input (its {int((win_pad < 0).sum())} "
        f"pad slots' L1 norm {pads:.3e} at the last block) against the default route's block, per row max err / "
        f"max|row|: worst {block_rel[worst]:.3e} (block {worst}; tol {ROW_TOL}), median "
        f"{statistics.median(block_rel):.3e}; the tower end to end over {vcfg.depth} blocks: "
        f"f32 with plain attention, resident vs default per row {rel32:.3e} (tol "
        f"{RESIDENT_F32_TOL}); bf16, against the default route in f32: the default route "
        f"{spread:.3e}, the resident route {rel_res:.3e}; bf16 resident vs default per row "
        f"{rel:.3e} (tol {RESIDENT_SPREADS} x {spread:.3e}), max abs {err:.3e}; flash launches "
        f"{n_flash} (the full-attention blocks over the padded window stream)")
    if (block_rel[worst] > ROW_TOL or rel32 > RESIDENT_F32_TOL
            or rel > RESIDENT_SPREADS * spread or n_flash != len(vcfg.fullatt_block_indexes)):
        raise AssertionError("switch window_resident: disagrees with the default route")
    del ref32, res32

    # single-mask decoding by stability, and a mask-prompted decode
    emb, _ = seg._seg_embedding(frames, expressions[0])
    feats = seg.encode_frames(frames)
    lang = emb[None, None, :].expand(len(frames), 1, emb.shape[-1])
    with torch.no_grad():
        multi = sam.decode_features_with_language(*feats, lang)
        single = sam.decode_features_with_language(*feats, lang, multimask_output=False)
        stable = (sam.sam_mask_decoder._stability_scores(single["low_res_masks"][:, 0])
                  >= sam.cfg.dynamic_multimask_stability_thresh)
        best = (single["low_res_masks"] == multi["low_res_masks"]).flatten(1).all(1)
        pix = feats[2] + sam.no_mem_embed.reshape(1, 1, 1, -1).to(feats[2].dtype)
        prompt = multi["low_res_masks"].permute(0, 2, 3, 1)
        prompted = sam.forward_sam_heads(pix, feats[:2], language_embd=lang, mask_inputs=prompt)
    agree = ((prompted["high_res_masks"] > 0) == (multi["high_res_masks"] > 0)).float().mean()
    log(f"switch single-mask decode: {int(stable.sum())} of {len(frames)} frames stable (the "
        f"first mask), {int((best & ~stable).sum())} the default route's best-IoU mask "
        f"(bit-equal); mask-prompted forward_sam_heads (the default route's low-res masks as "
        f"the dense prompt): masks {tuple(prompted['high_res_masks'].shape)}, agreement with "
        f"the default route {agree.item():.5f}")
    if not bool((stable | best).all()) or not torch.isfinite(single["high_res_masks"]).all():
        raise AssertionError("switch single-mask: a frame's mask is neither the stable first "
                             "mask nor the default route's")
    if not (torch.isfinite(prompted["high_res_masks"]).all()
            and prompted["high_res_masks"].shape == multi["high_res_masks"].shape
            and not torch.equal(prompted["high_res_masks"], multi["high_res_masks"])):
        raise AssertionError("switch mask prompt: no effect, or non-finite masks")

    # RGA3_GELU_EXACT=1: the erf GELU in every Hiera block
    logits = seg.decode_logits(feats, emb)
    os.environ["RGA3_GELU_EXACT"] = "1"
    try:
        reset_launches()
        logits_e = seg.decode_logits(seg.encode_frames(frames), emb)
        paths["switch_gelu_exact"] = read_path()
    finally:
        del os.environ["RGA3_GELU_EXACT"]
    calls = paths["switch_gelu_exact"][1]
    fused = [k for name in ("fused_window_block", "fused_global_block",
                            "fused_window_block_split", "fused_transition_block")
             for k in calls[name]]
    erf = all(k[-1] is False for k in fused) and any(k[3] == "gelu_erf" for k in calls["gemm"])
    agree = ((logits_e > 0) == (logits > 0)).float().mean().item()
    rel = ((logits_e - logits).abs().max() / logits.abs().max()).item()
    log(f"switch RGA3_GELU_EXACT=1: {len(fused)} fused block calls, all erf: {erf}; mask "
        f"logits against the tanh route max err / max|logit| {rel:.3e}, agreement {agree:.5f}")
    if not erf or agree <= 0.95:
        raise AssertionError("switch RGA3_GELU_EXACT: not the erf route, or disagrees")

    # the device preprocessing (a float cubic resize from the native frames)
    dseg = UniGRSegmentor(model, proc, num_frames_mllm=8, sam_chunk=8, device_preprocess=True)
    reset_launches()
    t0 = time.perf_counter()
    dmasks = dseg.segment_video_multi(frames, expressions)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paths["switch_device_preprocess"] = read_path()
    dfeat = dseg.encode_frames(frames)[2].float()
    feat_rel = ((dfeat - feats[2].float()).norm() / feats[2].float().norm()).item()
    agree = float((dmasks == masks).mean())
    log(f"switch device_preprocess: segment_video_multi {wall:.3f} s (cold); stride-16 "
        f"features rel err against the host route {feat_rel:.3e}, mask agreement {agree:.5f} "
        f"(foreground {dmasks.mean():.4f} vs {masks.mean():.4f}); {card_line}")
    if dmasks.shape != masks.shape or agree <= 0.95:
        raise AssertionError("switch device_preprocess: disagrees with the host route")
    del seg, dseg, feats, multi, single, prompted
    torch.cuda.empty_cache()
    return paths


# --------------------------------------------------------------------------
# STOM region QA (BASELINE config 5) on the int4 serving chat
# --------------------------------------------------------------------------


def stom_config():
    """The config embedded in the repo's `cotracker3_official.npz`: the
    official CoTracker3 dims (`cotracker3_offline_config()`: latent 128, 4
    levels, radius 3, hidden 384, 8 heads, 3 + 3 blocks, 64 virtual tracks)
    at model resolution 160x224, 4 iterations, bf16 compute."""
    from rga3_tpu_torch.models.stom.cotracker3 import cotracker3_offline_config

    return cotracker3_offline_config().replace(
        model_resolution=(160, 224), iters=4, compute_dtype="bfloat16")


def region_items(frames):
    """Two VideoInfer items on the smoke's video, each with an RGBA overlay
    drawn in numpy: a red rectangle outline on key frame 0, and a
    half-transparent ellipse mask on key frame 3."""
    import numpy as np

    h, w = frames[0].shape[:2]
    rect = np.zeros((h, w, 4), np.uint8)
    rect[140:340, 280:580] = (255, 0, 0, 255)
    rect[144:336, 284:576] = 0
    yy, xx = np.mgrid[:h, :w]
    mask = np.zeros((h, w, 4), np.uint8)
    mask[((yy - 260) / 90.0) ** 2 + ((xx - 500) / 140.0) ** 2 < 1] = (30, 220, 90, 128)
    return [
        {"id": "rect", "frames": frames, "question": "What is the marked object doing?",
         "vip_overlay": rect, "key_idx": 0, "shape": "rectangle"},
        {"id": "mask", "frames": frames, "question": "What color is the marked region?",
         "vip_overlay": mask, "key_idx": 3, "shape": "mask"},
    ]


def mean_flow(tracks, vis, key, idx):
    """The (dx, dy) `STOM._compose_from_tracks` translates a rectangle
    overlay by on frame idx, or None where it leaves the frame as it is."""
    import numpy as np

    flows = tracks[idx][vis[idx]] - tracks[key][vis[idx]]
    if len(flows) == 0:
        return None
    mags = np.linalg.norm(flows, axis=1)
    median = np.median(mags)
    mad = np.median(np.abs(mags - median))
    kept = flows[(mags >= median - 3 * mad) & (mags <= median + 3 * mad)]
    if len(kept) < vis[idx].shape[0] // 2:
        return None
    return float(np.mean(kept[:, 0])), float(np.mean(kept[:, 1]))


def stom_phase(chat4, frames, seed, card_line, read_path) -> dict:
    """`run_inference(chat4, 2 region items, use_stom=True, batch_size=2)`
    with the full-width CoTracker3 (random weights from the seed, flax's
    initialiser scales) on the card, its launches read after it; one
    `propagate_in_video` cold, warm and traced; the tracker in f32 on the
    card against the same weights on the CPU; track_batch against track.
    Returns the path's (launches, calls) and the CoTracker3 (for phase 4d)."""
    import numpy as np
    import torch
    from rga3_tpu_torch.evaluation.videoinfer import run_inference
    from rga3_tpu_torch.models.stom.cotracker3 import CoTracker3Offline, CoTracker3Predictor
    from rga3_tpu_torch.models.stom.stom import STOM
    from rga3_tpu_torch.ops.attention import reset_launches

    cfg = stom_config()
    model = CoTracker3Offline(cfg).to("cuda")
    model.init_weights(torch.Generator("cuda").manual_seed(seed))
    model.eval()
    log(f"stom: CoTracker3 {cfg}, {sum(p.numel() for p in model.parameters()) / 1e6:.3f} M "
        f"params (f32, computing in bf16), random from the seed; {card_line}")
    pred = CoTracker3Predictor(model)
    times = {"track": [], "track_batch": []}

    def timed(name, fn):
        def run(*args, **kw):
            t1 = time.perf_counter()
            out = fn(*args, **kw)  # numpy results: the device work has ended
            times[name].append(time.perf_counter() - t1)
            return out
        return run

    pred.track = timed("track", pred.track)
    pred.track_batch = timed("track_batch", pred.track_batch)
    stom = STOM(tracker=pred)
    items = region_items(frames)
    masks = [STOM._query_mask(it["vip_overlay"]) for it in items]
    n_pts = [min(len(pred._mask_points(m, 100)), pred.max_points) for m in masks]
    log(f"stom: tracked points N per item (100x100 grid in the query disc, at most "
        f"{pred.max_points}): " + ", ".join(f"{it['id']} {n}" for it, n in zip(items, n_pts)))

    out_dir = os.path.join(HERE, "build", "stom_phase")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "preds.jsonl")
    if os.path.exists(out_path):
        os.remove(out_path)  # run_inference resumes past the ids it finds
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t1 = time.perf_counter()
    n = run_inference(chat4, items, out_path, use_stom=True, batch_size=2, stom=stom,
                      stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    path = read_path()
    launches = path[0]
    per_forward = 7 * chat4.model.cfg.text.num_hidden_layers + 1
    forwards = chat4.last_stats["forwards"]
    with open(out_path) as f:
        preds = [json.loads(line) for line in f]
    log(f"stom run_inference (2 items, batch_size 2, int4 chat, {CHAT_TOKENS} new tokens): "
        f"{wall:.3f} s; STOM leg {stats['stom_s']:.3f} s (track_batch of 2, cold "
        f"{times['track_batch'][0]:.3f} s), answer_batch leg {stats['answer_s']:.3f} s "
        f"(prefill {chat4.last_stats['prefill_s']:.4f} s, {forwards} forwards); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the bf16 "
        f"UniGR and the int4 copy included); {card_line}")
    log(f"stom answers: {[(p['id'], p['pred'][:60]) for p in preds]}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if n != 2 or len(preds) != 2 or not all(isinstance(p["pred"], str) and p["pred"].strip()
                                            for p in preds):
        raise AssertionError(f"stom run_inference: {n} answers written, {preds}")
    if launches["int4_matmul"] != per_forward * forwards or launches["flash_attention"] <= 0:
        raise AssertionError(f"stom run_inference: {launches['int4_matmul']} int4 launches for "
                             f"{forwards} forwards, flash {launches['flash_attention']}")

    # the tracker alone: batch of 2 warm, then one propagate_in_video cold and warm
    arrs = [list(it["frames"]) for it in items]
    idxs = [it["key_idx"] for it in items]
    batch = pred.track_batch(arrs, masks, idxs)
    rect = items[0]
    t1 = time.perf_counter()
    single = stom.propagate_in_video(list(frames), rect["vip_overlay"], 0)
    cold = time.perf_counter() - t1
    t1 = time.perf_counter()
    stom.propagate_in_video(list(frames), rect["vip_overlay"], 0)
    warm = time.perf_counter() - t1
    t_len = len(frames)
    log(f"stom tracker ({t_len}-frame 480x854 clips, pre-resized to 160x224 on the card): "
        f"single cold {times['track'][0]:.4f} s, warm {times['track'][1]:.4f} s a clip; batch "
        f"of 2 cold {times['track_batch'][0] / 2:.4f} s, warm {times['track_batch'][1] / 2:.4f} "
        f"s a clip; propagate_in_video cold {cold:.4f} s, warm {warm:.4f} s (compositing "
        f"{warm - times['track'][1]:.4f} s of it); {card_line}")
    for (tr, vis), m in zip(batch, n_pts):
        if tr.shape != (t_len, m, 2) or not np.isfinite(tr).all():
            raise AssertionError(f"stom: tracks {tr.shape}, finite {np.isfinite(tr).all()}")
    if len(single) != t_len or single[0].shape != frames[0].shape:
        raise AssertionError("stom: propagate_in_video returned the wrong frames")
    busy = device_breakdown(lambda: stom.propagate_in_video(list(frames), rect["vip_overlay"], 0))
    log(f"profile (propagate_in_video, 8 frames): device busy in the traced call / wall of the "
        f"untraced warm call: {busy:.1f} / {warm * 1e3:.1f} ms = {busy / (warm * 1e3):.3f}; "
        f"{card_line}")

    # f32 (TF32 off since phase 1) on the card against the CPU, same weights.
    # Refinement multiplies a rounding difference many times over (the flow
    # embedding runs at up to ~1000 rad a grid pixel), so the gates hold one
    # iteration and the four are logged beside the CPU's own floor.
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    by_iters = {}
    for iters in (1, cfg.iters):
        c32 = cfg.replace(compute_dtype="float32", iters=iters)
        gm, cm = CoTracker3Offline(c32).cuda(), CoTracker3Offline(c32)
        gm.load_state_dict(sd)
        cm.load_state_dict(sd)
        by_iters[iters] = (CoTracker3Predictor(gm.eval()), CoTracker3Predictor(cm.eval(), device="cpu"))
    pts = pred._mask_points(masks[0], 100)
    outs = {}
    for iters, (pg, pc) in by_iters.items():
        for name, p in (("card", pg), ("cpu", pc)):
            prep = p._prep(list(frames), pts, 0)
            video, q, n_q, back = prep
            t1 = time.perf_counter()
            raw = p._forward([prep])
            outs[iters, name] = ({k: v[0].float().cpu().numpy() for k, v in raw.items()},
                                 video, q, n_q, back)
            log(f"stom f32 {iters}-iteration forward on the {name}: "
                f"{time.perf_counter() - t1:.3f} s")
    (g1, vid_g, q, n_q, back), (c1, vid_c, *_) = outs[1, "card"], outs[1, "cpu"]
    if not torch.equal(vid_g.cpu(), vid_c):
        raise AssertionError("stom: the pre-resize differs between the card and the CPU")
    track_err = np.abs((g1["tracks"][-1] - c1["tracks"][-1])[:, :n_q] * back).max()
    logit_err = max(np.abs(g1[k] - c1[k]).max() / np.abs(c1[k]).max() for k in ("vis", "conf"))
    tg, vg = by_iters[1][0]._finish(g1["tracks"][-1], g1["vis"], g1["conf"], n_q, back)
    tc, vc = by_iters[1][1]._finish(c1["tracks"][-1], c1["vis"], c1["conf"], n_q, back)
    fallback = [bool(v[0].mean() < 0.5) for v in (vg, vc)]  # track_in_video's rule
    vg, vc = (np.ones_like(v) if fb else v for v, fb in zip((vg, vc), fallback))
    rgb = STOM._frames_to_rgb(frames)
    comp_g = stom._compose_from_tracks(rgb, tg, vg, rect["vip_overlay"], 0, "rectangle")
    comp_c = stom._compose_from_tracks(rgb, tc, vc, rect["vip_overlay"], 0, "rectangle")
    excepted, differ, moved = 0, [], 0
    for f in range(t_len):
        flow = mean_flow(tc, vc, 0, f) if f else None
        near_tie = flow is not None and any(abs(abs(v - math.floor(v)) - 0.5) < TIE_MARGIN
                                            for v in flow)
        moved += flow is not None
        if near_tie:
            excepted += 1
        elif not np.array_equal(comp_g[f], comp_c[f]):
            differ.append(f)
    log(f"stom card vs CPU, f32, 1 iteration, item rect ({n_q} points): tracks max err "
        f"{track_err:.3e} px (tol {TRACK_TOL_PX}), vis/conf logits max err / max|logit| "
        f"{logit_err:.3e} (tol {LOGIT_TOL}), visibility equal on {(vg == vc).mean():.4f} "
        f"(key-frame fallback to all visible: card {fallback[0]}, CPU {fallback[1]}); "
        f"composited frames: {t_len - excepted - len(differ)} of {t_len} byte-identical, "
        f"{excepted} excepted within {TIE_MARGIN} px of a rounding tie, {moved} frames "
        f"translated; {card_line}")
    if track_err > TRACK_TOL_PX or logit_err > LOGIT_TOL or differ:
        raise AssertionError(f"stom: the card disagrees with the CPU (frames {differ})")
    gi, ci = outs[cfg.iters, "card"][0], outs[cfg.iters, "cpu"][0]
    with torch.inference_mode():  # the CPU against itself, input moved 1e-3 of a level
        nudged = by_iters[cfg.iters][1].model(vid_c[None].float() + 1e-3, torch.from_numpy(q[None]))
    floor = nudged["tracks"][0].numpy()
    for it in range(cfg.iters):
        log(f"stom card vs CPU, f32, {cfg.iters} iterations, iteration {it + 1}: tracks max err "
            f"{np.abs((gi['tracks'][it] - ci['tracks'][it])[:, :n_q] * back).max():.3e} px; "
            f"the CPU with its input moved by 1e-3 of a level: "
            f"{np.abs((floor[it] - ci['tracks'][it])[:, :n_q] * back).max():.3e} px")

    # bf16: the batch's forward (track_batch's) against single ones (track's)
    # on the card, each iteration, beside two other roundings of the same
    # clip at iteration 1: bf16 against f32 on the card, and bf16 on the card
    # against bf16 on the CPU. Iteration 1 of the batch must lie within
    # BATCH_BF16_FACTOR of bf16 against f32 (max and mean); later iterations
    # are logged
    cpu16 = CoTracker3Offline(cfg)
    cpu16.load_state_dict(sd)
    cpu16 = CoTracker3Predictor(cpu16.eval(), device="cpu")
    preps = [pred._prep(arrs[j], pred._mask_points(masks[j], 100), idxs[j])
             for j in range(len(items))]
    tr_batch = pred._forward(preps)["tracks"].float().cpu().numpy()
    for j, (it, prep) in enumerate(zip(items, preps)):
        n_j, back_j = prep[2], prep[3]

        def diff(a, b):
            d = np.abs((a - b)[:, :n_j] * back_j)
            return d.max(), d.mean()

        tr_single = pred._forward([prep])["tracks"][0].float().cpu().numpy()
        tr_f32 = by_iters[cfg.iters][0]._forward([prep])["tracks"][0].float().cpu().numpy()
        prep_cpu = (prep[0].cpu(),) + tuple(prep[1:])
        tr_cpu = cpu16._forward([prep_cpu])["tracks"][0].float().numpy()
        gaps = [diff(tr_batch[j, i], tr_single[i]) for i in range(cfg.iters)]
        spread, cpu_gap = diff(tr_f32[0], tr_single[0]), diff(tr_cpu[0], tr_single[0])
        log(f"stom bf16 track_batch vs track on the card, item {it['id']}: by iteration, "
            f"max / mean |tracks| diff "
            + ", ".join(f"{g[0]:.3e} / {g[1]:.3e}" for g in gaps)
            + f" px; at iteration 1, bf16 vs f32 on the card {spread[0]:.3e} / {spread[1]:.3e} "
            f"px, bf16 card vs bf16 CPU {cpu_gap[0]:.3e} / {cpu_gap[1]:.3e} px (gate: the batch "
            f"within {BATCH_BF16_FACTOR} x bf16 vs f32); {card_line}")
        if not all(g <= BATCH_BF16_FACTOR * r for g, r in zip(gaps[0], spread)):
            raise AssertionError("stom: bf16 track_batch differs from track beyond the bf16 "
                                 "rounding at iteration 1")
    del cpu16

    # track_batch against track on the card (f32, one iteration)
    pg = by_iters[1][0]
    got = pg.track_batch(arrs, masks, idxs)
    for j, it in enumerate(items):
        tr_s, vis_s = pg.track(arrs[j], masks[j], idxs[j])
        err, agree = np.abs(got[j][0] - tr_s).max(), (got[j][1] == vis_s).mean()
        log(f"stom f32 track_batch vs track on the card, item {it['id']}: max err {err:.3e} px "
            f"(tol {BATCH_TOL_PX}), visibility equal on {agree:.4f} (at least {BATCH_VIS})")
        if not (err <= BATCH_TOL_PX and agree >= BATCH_VIS):
            raise AssertionError("stom: track_batch disagrees with track")
    del pred, stom, by_iters
    torch.cuda.empty_cache()
    return {"region_qa": path}, model


# --------------------------------------------------------------------------
# the region-QA benchmark drivers through their CLIs, on the int4 chat
# --------------------------------------------------------------------------


class RecordingChat:
    """A `UniGRChat` that records each `answer`'s prompt, frames, answer and
    forwards, and the token ids each generation returned."""

    def __init__(self, chat):
        self.chat, self.calls, self.tokens = chat, [], []
        generate = chat._generate

        def recorded(encs, length_bucket, suppress_ids):
            toks = generate(encs, length_bucket, suppress_ids)
            self.tokens.append((toks.clone(), list(suppress_ids)))
            return toks

        chat._generate = recorded

    def answer(self, question, video_frames=None, images=None, suppress_ids=()):
        out = self.chat.answer(question, video_frames=video_frames, images=images,
                               suppress_ids=suppress_ids)
        self.calls.append((question, [f.copy() for f in video_frames or []], out,
                           self.chat.last_stats["forwards"]))
        return out

    def answer_batch(self, questions, **kw):
        out = self.chat.answer_batch(questions, **kw)
        self.calls.append((questions, None, out, self.chat.last_stats["forwards"]))
        return out


def region_qa_phase(chat4, tracker, frames, seed, card_line, read_path) -> dict:
    """Phase 4d (see the module docstring): the three region-QA paths through
    their CLIs (`eval_videoinfer.main`, `eval_region_qa.main`) on phase 4's
    int4 chat, STOM over phase 4b's CoTracker3 written as a weight file and
    named by RGA3_STOM_TRACKER; STOM over LK on the host; phase 4b's tracker
    through the official checkpoint layout. Works under build/region_qa/.
    Returns the paths' (launches, calls)."""
    import dataclasses
    import random

    import numpy as np
    import torch
    from rga3_tpu_torch.evaluation import eval_region_qa, eval_videoinfer
    from rga3_tpu_torch.evaluation.caption_metrics import evaluate_captions, meteor_stages
    from rga3_tpu_torch.evaluation.region_qa_eval import eval_videorefer, suppress_token_ids
    from rga3_tpu_torch.models.stom.convert import (
        build_cotracker3_from_checkpoint, export_torch_state_dict,
    )
    from rga3_tpu_torch.models.stom.cotracker3 import CoTracker3Predictor, save_cotracker3
    from rga3_tpu_torch.models.stom.stom import STOM
    from rga3_tpu_torch.models.stom.tracker import LKTracker
    from rga3_tpu_torch.ops.attention import reset_launches
    from rga3_tpu_torch.tools.synth_trees import (
        shifted_patch_clip, write_videoinfer_tree, write_videorefer_tree, write_vipbench_tree,
    )

    work = os.path.join(HERE, "build", "region_qa")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    paths = {}
    model = (chat4.model, chat4.processor)
    per_forward = 7 * chat4.model.cfg.text.num_hidden_layers + 1
    npz = os.path.join(work, "cotracker3_phase4b.npz")
    save_cotracker3(npz, tracker, tracker.cfg)
    saved_choice = os.environ.get("RGA3_STOM_TRACKER")
    os.environ["RGA3_STOM_TRACKER"] = npz

    def counted(name, n_forwards):
        """Read the path's counts after its cold call; int4_matmul once a
        projection a forward, flash_attention launched."""
        launches, calls = read_path()
        paths[name] = (launches, calls)
        log(f"region_qa {name}: launches { {k: v for k, v in launches.items() if v} }")
        if launches["int4_matmul"] != per_forward * n_forwards or launches["flash_attention"] <= 0:
            raise AssertionError(f"region_qa {name}: int4_matmul {launches['int4_matmul']} for "
                                 f"{n_forwards} forwards x {per_forward}, flash_attention "
                                 f"{launches['flash_attention']}")

    try:
        # -- VideoInfer: 2 shards, a resume, merge, eval
        t0 = time.perf_counter()
        vi = write_videoinfer_tree(os.path.join(work, "videoinfer"), seed=seed,
                                   n_videos=REGION_VIDEOS, n_frames=REGION_FRAMES,
                                   size=REGION_SIZE, n_expressions=2, n_qa=2)
        log(f"region_qa: VideoInfer tree, {REGION_VIDEOS} videos x {REGION_FRAMES} frames at "
            f"{REGION_SIZE[0]}x{REGION_SIZE[1]}, {len(vi['ids'])} QA, written in "
            f"{time.perf_counter() - t0:.2f} s")
        data = ["--data_root", vi["data_root"]]
        flags = ["--use_stom", "--batch_size", "4", "--subset_num", "2"]
        torch.cuda.reset_peak_memory_stats()
        shard_ids, shard_files = [], []
        for k in range(2):
            out = os.path.join(work, f"pred_{k}.jsonl")
            if k == 0:
                reset_launches()
            t1 = time.perf_counter()
            res = eval_videoinfer.main(["--stage", "infer", *data, "--out", out, *flags,
                                        "--subset_idx", str(k)], model=model)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            stats = res["chat"].last_stats
            if k == 0:
                counted("videoinfer", stats["forwards"])
            sec = res["seconds"]
            log(f"region_qa videoinfer shard {k} ({'cold' if k == 0 else 'warm'}): {res['n']} "
                f"items in {wall:.3f} s: load {sec['load']:.3f} s, STOM leg {sec['stom_s']:.3f} s "
                f"(wait {sec['stom_wait_s']:.3f} s), answer_batch leg {sec['answer_s']:.3f} s "
                f"(prefill {stats['prefill_s']:.4f} s, {stats['forwards']} forwards); "
                f"{card_line}")
            with open(out) as f:
                shard_ids.append([json.loads(line)["id"] for line in f])
            shard_files.append(out)
            if res["n"] != 4:
                raise AssertionError(f"region_qa videoinfer shard {k}: {res['n']} items")
        if sorted(shard_ids[0] + shard_ids[1]) != sorted(vi["ids"]) or set(shard_ids[0]) & set(
                shard_ids[1]):
            raise AssertionError(f"region_qa videoinfer: shards {shard_ids} are not the ids")
        before = open(shard_files[0], "rb").read()
        again = eval_videoinfer.main(["--stage", "infer", *data, "--out", shard_files[0], *flags,
                                      "--subset_idx", "0"], model=model)
        if again["n"] != 0 or open(shard_files[0], "rb").read() != before:
            raise AssertionError("region_qa videoinfer: the resume wrote again")
        merged = os.path.join(work, "pred.jsonl")
        t1 = time.perf_counter()
        m = eval_videoinfer.main(["--stage", "merge", "--out", merged, "--shards",
                                  os.path.join(work, "pred_*.jsonl")])
        t_merge = time.perf_counter() - t1
        t1 = time.perf_counter()
        scores = eval_videoinfer.main(["--stage", "eval", *data, "--out", merged])
        t_eval = time.perf_counter() - t1
        answers = eval_videoinfer.load_answers(vi["data_root"])
        with open(merged) as f:
            preds = [json.loads(line) for line in f]
        direct = evaluate_captions([p["pred"] for p in preds], [[answers[p["id"]]] for p in preds])
        direct["n"] = len(preds)
        log(f"region_qa videoinfer: resume wrote {again['n']}; merge {m['n']} in {t_merge:.3f} "
            f"s, eval {t_eval:.3f} s: {scores} (METEOR stages {meteor_stages()}); peak memory "
            f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card_line}")
        if m["n"] != len(vi["ids"]) or scores != direct:
            raise AssertionError(f"region_qa videoinfer: merged {m['n']}, scores {scores} vs "
                                 f"{direct}")

        # -- VideoRefer-Bench-Q: records against direct answers of the recorded prompts
        t0 = time.perf_counter()
        vr = write_videorefer_tree(os.path.join(work, "videorefer"), seed=seed, n_items=2,
                                   n_frames=REFER_FRAMES, size=REGION_SIZE)
        log(f"region_qa: VideoRefer-Bench-Q tree, 2 items of {REFER_FRAMES} frames at "
            f"{REGION_SIZE[0]}x{REGION_SIZE[1]}, written in {time.perf_counter() - t0:.2f} s")
        built = eval_region_qa.build_chat
        proxies = []

        def recording_chat(args, model=None):
            chat, proc = built(args, model)
            proxies.append(RecordingChat(chat))
            return proxies[-1], proc

        eval_region_qa.build_chat = recording_chat
        try:
            out = os.path.join(work, "videorefer.jsonl")
            random.seed(seed)  # the overlays' line widths are drawn from Python's random
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t1 = time.perf_counter()
            res = eval_region_qa.main(["--bench", "videorefer", "--question_file",
                                       vr["question_file"], "--video_folder", vr["video_folder"],
                                       "--out", out, "--num_frames", "16", "--max_new_tokens",
                                       "16"], model=model)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            rec = proxies[-1]
            counted("videorefer", sum(c[3] for c in rec.calls))
            sec = res["seconds"]
            log(f"region_qa videorefer (cold): {res['new']} items in {wall:.3f} s: STOM leg "
                f"{sec['stom_s']:.3f} s, answer leg {sec['answer_s']:.3f} s "
                f"({[c[3] for c in rec.calls]} forwards); peak memory allocated "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card_line}")
            with open(out) as f:
                records = [json.loads(line) for line in f]
            for (prompt, fr, answer, _), r in zip(rec.calls, records):
                again = rec.chat.answer(prompt, video_frames=fr)
                log(f"region_qa videorefer item {r['idx']}: {len(fr)} frames, pred {r['pred']!r}, "
                    f"answer {answer[:40]!r}, direct {again[:40]!r}; prompt {prompt[:90]!r}")
                if again != answer or r["pred"] != (again[0] if again else ""):
                    raise AssertionError("region_qa videorefer: the record differs from a direct "
                                         "answer of its prompt and frames")
            if len(records) != 2 or len(rec.calls) != 2 or any(len(c[1]) != 16
                                                               for c in rec.calls):
                raise AssertionError(f"region_qa videorefer: {len(records)} records")
            acc = eval_region_qa.main(["--bench", "videorefer", "--stage", "eval", "--out", out])
            if acc != eval_videorefer(out):
                raise AssertionError("region_qa videorefer: the eval stage's accuracies differ")
            log(f"region_qa videorefer eval: {acc}")

            # -- ViP-Bench: 2 batches of 2, [SEG] and "segmentation" banned
            vip = write_vipbench_tree(os.path.join(work, "vipbench"), seed=seed,
                                      n_images=4, size=VIP_SIZE)
            answers_path = os.path.join(work, "vipbench_answers.json")
            reset_launches()
            t1 = time.perf_counter()
            res = eval_region_qa.main(["--bench", "vipbench", "--question_file",
                                       vip["question_file"], "--image_folder",
                                       vip["image_folder"], "--out", answers_path,
                                       "--batch_size", "2", "--max_new_tokens",
                                       str(VIP_TOKENS)], model=model)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            rec = proxies[-1]
            counted("vipbench", sum(c[3] for c in rec.calls))
            sup = suppress_token_ids(chat4.processor.tokenizer)
            generated = set(int(t) for toks, _ in rec.tokens for t in toks.flatten())
            with open(answers_path) as f:
                written = json.load(f)
            log(f"region_qa vipbench (cold): {res['new']} images at {VIP_SIZE[0]}x{VIP_SIZE[1]} "
                f"in {wall:.3f} s ({[c[3] for c in rec.calls]} forwards); suppressed ids {sup}; "
                f"answers {[(k, v[:40]) for k, v in written.items()]}; {card_line}")
            if (not sup or 151665 not in sup or generated & set(sup)
                    or any(s != sup for _, s in rec.tokens) or len(rec.tokens) != 2
                    or sorted(written) != [f"v1_{i}" for i in range(4)]):
                raise AssertionError(f"region_qa vipbench: suppressed {sup}, generated "
                                     f"{sorted(generated & set(sup))} of them, answers "
                                     f"{sorted(written)}")
        finally:
            eval_region_qa.build_chat = built
    finally:
        if saved_choice is None:
            os.environ.pop("RGA3_STOM_TRACKER", None)
        else:
            os.environ["RGA3_STOM_TRACKER"] = saved_choice

    # -- STOM over LK on the host: phase 4b's items, and a known shift
    import cv2

    lk = STOM(tracker=LKTracker())
    for it in region_items(frames):
        times = []
        for _ in range(2):
            t1 = time.perf_counter()
            out = lk.propagate_in_video(list(it["frames"]), it["vip_overlay"], it["key_idx"],
                                        shape=it["shape"])
            times.append(time.perf_counter() - t1)
        log(f"region_qa LK STOM, item {it['id']} ({len(out)} frames at {frames[0].shape[0]}x"
            f"{frames[0].shape[1]}, OpenCV {cv2.__version__}): cold {times[0]:.4f} s, warm "
            f"{times[1]:.4f} s a clip on the host; {card_line}")
        if len(out) != len(frames) or out[0].shape != frames[0].shape:
            raise AssertionError("region_qa LK: wrong frames")
    step, key = (6, -3), 2
    clip, boxes = shifted_patch_clip(np.random.default_rng(seed), 8, frames[0].shape[:2],
                                     (120, 160), step, (300, 260))
    y0, y1, x0, x1 = boxes[key]
    vip = np.zeros(clip[0].shape[:2] + (4,), np.uint8)
    vip[y0 - 4:y1 + 4, x0 - 4:x1 + 4] = (255, 0, 0, 255)
    vip[y0:y1, x0:x1] = 0
    moved = lk.propagate_in_video(clip, vip, key)
    offsets = []
    for t, f in enumerate(moved):
        ys, xs = np.nonzero((f[..., 0] == 255) & (f[..., 1] == 0) & (f[..., 2] == 0))
        offsets.append((int(xs.min() - (x0 - 4)), int(ys.min() - (y0 - 4))))
    errs = [max(abs(dx - (t - key) * step[0]), abs(dy - (t - key) * step[1]))
            for t, (dx, dy) in enumerate(offsets)]
    log(f"region_qa LK shift check: patch moved ({step[0]}, {step[1]}) px a frame, rectangle "
        f"offsets {offsets}, max error {max(errs)} px (tol 1); {card_line}")
    if max(errs) > 1:
        raise AssertionError("region_qa LK: the propagated rectangle misses the known shift")

    # -- phase 4b's tracker through the official checkpoint layout
    ckpt = os.path.join(work, "scaled_offline.pth")
    t1 = time.perf_counter()
    torch.save(export_torch_state_dict(tracker), ckpt)
    rebuilt = build_cotracker3_from_checkpoint(ckpt, base=stom_config())
    t_conv = time.perf_counter() - t1
    want = dataclasses.asdict(stom_config())
    got = dataclasses.asdict(rebuilt.cfg)
    items = region_items(frames)
    preds = [CoTracker3Predictor(m) for m in (tracker, rebuilt)]
    mask = STOM._query_mask(items[0]["vip_overlay"])
    prep = preds[0]._prep(list(frames), preds[0]._mask_points(mask, 100), 0)
    outs = [p._forward([prep]) for p in preds]
    equal = all(torch.equal(outs[0][k], outs[1][k]) for k in ("tracks", "vis", "conf"))
    log(f"region_qa convert: official-layout state dict ({os.path.getsize(ckpt) / 1e6:.1f} MB) "
        f"saved and rebuilt in {t_conv:.2f} s; inferred config equal to stom_config(): "
        f"{got == want}; tracks, vis and conf bit-equal to phase 4b's module on one clip: "
        f"{equal}; {card_line}")
    if got != want or not equal:
        raise AssertionError(f"region_qa convert: config {got} vs {want}, outputs equal {equal}")
    del rebuilt, preds, outs
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return paths


# --------------------------------------------------------------------------
# STOM's tracker trained through its CLI, its weight file and its scorer
# --------------------------------------------------------------------------


def oracle_reports(n_points: int, t: int):
    """The fixed and serving suites scored by a tracker that returns each
    clip's ground truth (regenerated from the suite's own seeds, in its
    order): every error must be 0."""
    import numpy as np
    from rga3_tpu_torch.models.stom import synth

    def replay(clips):
        it = iter(clips)
        return lambda frames_u8, pts0, qidx: next(it)

    fixed = [synth.make_synthetic_case(np.random.default_rng(1000 + s), case, t=t, h=64, w=64,
                                       n_points=n_points)[2]
             for case in synth.BENCH_CASES for s in (0, 1, 2)]
    serving = [synth.make_training_clip(np.random.default_rng(5000 + s), t=t, h=160, w=224,
                                        n_points=n_points, max_speed=10.0,
                                        random_query_frame=False)[2] for s in range(8)]
    return (synth.benchmark_tracker(replay(fixed), t=t, n_points=n_points),
            synth.benchmark_tracker_serving(replay(serving), t=t, n_points=n_points))


def report_numbers(report):
    """(key, number) of every number in a (nested) report."""
    for k, v in report.items():
        if isinstance(v, dict):
            yield from report_numbers(v)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            yield k, v


def zero_gradient_mask(name, shape):
    """The elements of CoTracker3's tensor `name` whose gradient is zero in
    exact arithmetic: a conv bias of the encoder before an instance norm,
    the key half of a `to_kv` bias (softmax drops a constant)."""
    import numpy as np

    zero = np.zeros(shape, bool)
    if name.endswith("to_kv.bias"):
        zero[:shape[0] // 2] = True
    elif name.startswith("fnet.") and name.endswith(".bias") and "conv3" not in name:
        zero[:] = True
    return zero


def compare_steps(card, cpu, lr, card_grads, cpu_grads):
    """Card against CPU over a check's two steps. card and cpu: (before,
    after) state dicts; card_grads and cpu_grads: the gradients each step
    took, one {name: tensor} a step. Returns {"worst", "worst_name"}: the
    largest |difference| of the moves / lr and its tensor; "mean": the
    largest tensor mean of that over the elements whose four gradients have
    one sign; "share": the share of elements whose moves differ by more than
    STOM_UPDATE_MAX x lr; "zero_move": the largest zero-gradient move / lr;
    {"grad", "grad_name"}: the largest tensor L2 distance of the card's
    gradient from the CPU's / the CPU's L2 norm, and its tensor."""
    import numpy as np

    out = {"worst": 0.0, "worst_name": "", "mean": 0.0, "zero_move": 0.0, "grad": 0.0,
           "grad_name": ""}
    beyond = total = 0
    for name, b in cpu[0].items():
        got = card[1][name].cpu().numpy() - card[0][name].cpu().numpy()
        want = cpu[1][name].numpy() - b.numpy()
        zero = zero_gradient_mask(name, want.shape)
        out["zero_move"] = max(out["zero_move"], float(np.abs(got[zero]).max(initial=0) / lr),
                               float(np.abs(want[zero]).max(initial=0) / lr))
        if zero.all():
            continue
        diff = np.abs(got[~zero] - want[~zero]) / lr
        if diff.max() > out["worst"]:
            out["worst"], out["worst_name"] = float(diff.max()), name
        beyond += int((diff > STOM_UPDATE_MAX).sum())
        total += diff.size
        grads = [g[name].detach().cpu().double().numpy()[~zero] for g in (*card_grads, *cpu_grads)]
        signs = np.stack([np.sign(g) for g in grads])
        one_sign = (signs == signs[0]).all(axis=0)
        out["mean"] = max(out["mean"], float(diff[one_sign].mean()) if one_sign.any() else 0.0)
        card_g, cpu_g = grads[len(card_grads) - 1], grads[-1]
        apart = np.linalg.norm(card_g - cpu_g)
        rel = float(apart / np.linalg.norm(cpu_g)) if apart else 0.0
        if rel > out["grad"]:
            out["grad"], out["grad_name"] = rel, name
    out["share"] = beyond / total
    return out


def stom_train_phase(frames, card_line, read_path, device="cuda") -> None:
    """Phase 4e (see the module docstring): `train_cotracker.main` on the
    layered curriculum at the official dims, a resume from its file, the
    flat curriculum with CoTrackerLite at its default width; the layered
    step in f32 on the card against the CPU; the file through
    `load_cotracker3`, `default_tracker` and `bench_stom_synth`. Works under
    build/stom_train/. No kernel of the port may launch."""
    import numpy as np
    import torch
    from rga3_tpu_torch.models.stom import synth
    from rga3_tpu_torch.models.stom.cotracker3 import load_cotracker3
    from rga3_tpu_torch.models.stom.stom import STOM, default_tracker
    from rga3_tpu_torch.ops.attention import reset_launches
    from rga3_tpu_torch.tools import bench_stom_synth
    from rga3_tpu_torch.tools import train_cotracker as tc

    work = os.path.join(HERE, "build", "stom_train")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    args = tc.parse_args(STOM_TRAIN_ARGV)
    h, w = tc.layered_config(args).model_resolution
    rng = np.random.default_rng(0)
    for tex in ("noise", "photo"):
        t1 = time.perf_counter()
        for _ in range(4):
            synth.make_training_clip(rng, t=args.frames, h=h, w=w, n_points=args.points,
                                     texture=tex)
        log(f"stom_train: make_training_clip at {h}x{w}, {args.frames} frames, {tex}: "
            f"{(time.perf_counter() - t1) / 4:.4f} s a clip on the host (one thread); "
            f"{card_line}")

    def summary(name, run, n_steps):
        steps = run["step_s"]
        warm = statistics.median(steps[1:]) if len(steps) > 1 else float("nan")
        extra = ""
        if "wait_s" in run:
            extra = (f"; wait on the pool: first {run['wait_s'][0]:.3f} s, then median "
                     f"{statistics.median(run['wait_s'][1:]):.4f} s; fresh clips a step: "
                     f"median {statistics.median(run['fresh'][1:])}, {sum(run['fresh'])} in all")
        log(f"stom_train {name}: {n_steps} steps; seconds a step cold {steps[0]:.3f}, warm "
            f"median {warm:.4f} (min {min(steps[1:]):.4f}, max {max(steps[1:]):.4f}); loss "
            f"first {run['losses'][0]:.4f}, last {run['losses'][-1]:.4f}{extra}; "
            f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"{(torch.cuda.max_memory_allocated() - resident) / 2**30:.2f} GiB above the "
            f"{resident / 2**30:.2f} GiB resident at the phase's start (the phase-3 UniGR); "
            f"{card_line}")
        if len(run["losses"]) != n_steps or not np.isfinite(run["losses"]).all():
            raise AssertionError(f"stom_train {name}: losses {run['losses']}")

    # -- the layered curriculum at the official dims, then a resume from its file
    ct3 = os.path.join(work, "ct3_official.npz")
    base = [*STOM_TRAIN_ARGV, "--pool-size", str(STOM_POOL), "--save-every", "0",
            "--device", device]
    log(f"stom_train: layered run {' '.join(STOM_TRAIN_ARGV)}; cut against the release run "
        f"(6000 steps, pool 512): {STOM_TRAIN_STEPS} steps, pool {STOM_POOL}, then a resume "
        f"of {STOM_RESUME_STEPS} steps")
    t1 = time.perf_counter()
    run1 = tc.main([*base, "--steps", str(STOM_TRAIN_STEPS), "--out", ct3])
    torch.cuda.synchronize()
    log(f"stom_train layered: {time.perf_counter() - t1:.2f} s with the pool's fill and the "
        f"fixed suite; report {json.dumps(run1['report'])}")
    summary("layered (official dims, bf16, batch 8)", run1, STOM_TRAIN_STEPS)
    model1 = run1["model"]
    file_model, file_cfg = load_cotracker3(ct3, device=device)
    f16 = {k: v.half().float() for k, v in model1.state_dict().items()}
    same = all(torch.equal(v, f16[k]) for k, v in file_model.state_dict().items())
    log(f"stom_train: {ct3} ({os.path.getsize(ct3) / 1e6:.1f} MB, f16) read back by "
        f"load_cotracker3: config equal {file_cfg == run1['cfg']}, weights bit-equal to the "
        f"model's rounded to f16: {same}")
    if file_cfg != run1["cfg"] or not same:
        raise AssertionError("stom_train: the weight file does not hold the trained model")
    # the device alone: aggregating a step's ~15k host launches takes ~20 s
    busy = device_breakdown(lambda: run1["step"](*tc.to_device(device, *run1["batch"])))
    warm = statistics.median(run1["step_s"][1:])
    log(f"profile (a warm layered step, batch 8): device busy in the traced step / the untraced "
        f"warm median step: {busy:.1f} / {warm * 1e3:.1f} ms = {busy / (warm * 1e3):.3f}; "
        f"{card_line}")
    resumed = tc.build_layered(tc.parse_args([*base, "--resume", ct3]))[0]
    same = all(torch.equal(v, f16[k]) for k, v in resumed.state_dict().items())
    if not same:
        raise AssertionError("stom_train: --resume did not start from the file")
    del resumed
    run2 = tc.main([*base, "--steps", str(STOM_RESUME_STEPS), "--resume", ct3,
                    "--out", os.path.join(work, "ct3_resumed.npz")])
    summary("layered, resumed from its file (starts from the f16 weights: checked)", run2,
            STOM_RESUME_STEPS)

    # -- the flat curriculum with CoTrackerLite at its default width
    lite = os.path.join(work, "lite.npz")
    run3 = tc.main([*STOM_LITE_ARGV, "--steps", str(STOM_LITE_STEPS), "--out", lite,
                    "--device", device])
    summary("flat lite (dim 256, 8 heads, 3 block pairs, 4 scales, 4 iterations, 64x64)",
            run3, STOM_LITE_STEPS)
    log(f"stom_train flat lite: held-out {run3['held_out_px']:.3f} px, stay-put "
        f"{run3['stayput_px']:.3f} px")

    # -- one layered step in f32 on the card against the CPU, same weights and
    # batch, at one refinement iteration (four logged)
    f32_argv = [a for a in STOM_TRAIN_ARGV if a != "--bf16"]
    batch = tuple(x[:STOM_CHECK_BATCH] for x in run1["batch"])
    sd = {k: v.detach().cpu().clone() for k, v in model1.state_dict().items()}
    for iters in (1, 4):
        check = tc.parse_args([*f32_argv, "--train-iters", str(iters), "--steps", "10",
                               "--batch", str(STOM_CHECK_BATCH)])
        res = {}
        for dev in (device, "cpu"):
            model, cfg, opt, step = tc.build_layered(check, dev)
            model.load_state_dict(sd)
            before = {k: v.detach().clone() for k, v in model.state_dict().items()}
            grads, opt_step = [], opt.step

            def keep_grads_and_step(opt=opt, grads=grads, opt_step=opt_step):
                grads.append({n: g.detach().clone() for n, g in opt.grads().items()
                              if g is not None})
                return opt_step()

            opt.step = keep_grads_and_step
            t1 = time.perf_counter()
            outs = [step(*tc.to_device(dev, *batch)) for _ in range(2 if iters == 1 else 1)]
            losses = [float(o[0]) for o in outs]
            aux = [float(a) for a in outs[0][1]]
            res[dev] = (losses, aux, before, {k: v.detach() for k, v in model.state_dict().items()},
                        time.perf_counter() - t1, opt.schedule(1), grads)
            del model, opt, step
        (gl, ga, gb, gaft, gs, lr, gg), (cl, ca, cb, caft, cs, _, cg) = res[device], res["cpu"]
        loss_rel = max(abs(g - c) / abs(c) for g, c in zip(gl, cl))
        px = max(abs(g - c) for g, c in zip(ga, ca))
        msg = (f"stom_train f32 layered step, card vs CPU, {iters} iteration(s), batch "
               f"{STOM_CHECK_BATCH}: loss {gl} vs {cl} (rel {loss_rel:.3e}), vis_px / hid_px "
               f"{ga} vs {ca} (max diff {px:.3e} px); card {gs:.2f} s, CPU {cs:.2f} s")
        if iters == 1:
            c = compare_steps((gb, gaft), (cb, caft), lr, gg, cg)
            log(f"{msg}; each tensor's gradient within {c['grad']:.3e} of the CPU's in L2 "
                f"({c['grad_name']}; tol {STOM_GRAD_RTOL}); after the second step (lr {lr:.3e}) "
                f"the parameters' moves differ by at most {c['worst']:.3e} x lr "
                f"({c['worst_name']}), by more than {STOM_UPDATE_MAX} x lr in a share "
                f"{c['share']:.3e} of the elements (tol {STOM_UPDATE_SHARE}), a tensor's mean "
                f"over the elements whose gradients have one sign by {c['mean']:.3e} x lr (tol "
                f"{STOM_UPDATE_MEAN}); zero-gradient moves <= {c['zero_move']:.3f} x lr (tol "
                f"1.5); loss tol {STOM_LOSS_RTOL}, px tol {TRACK_TOL_PX}; {card_line}")
            if (loss_rel > STOM_LOSS_RTOL or px > TRACK_TOL_PX or c["grad"] > STOM_GRAD_RTOL
                    or c["share"] > STOM_UPDATE_SHARE or c["mean"] > STOM_UPDATE_MEAN
                    or c["zero_move"] > 1.5):
                raise AssertionError(f"stom_train: the card's f32 step disagrees with the CPU's: "
                                     f"loss rel {loss_rel}, px {px}, {c}")
        else:
            log(f"{msg} (logged, not gated: the refinement is chaotic past one iteration)")

    # -- the file as STOM's tracker, and scored
    saved_choice = os.environ.get("RGA3_STOM_TRACKER")
    os.environ["RGA3_STOM_TRACKER"] = ct3
    try:
        tracker = default_tracker()
        for it in region_items(frames):
            mask = STOM._query_mask(it["vip_overlay"])
            t1 = time.perf_counter()
            tracks, vis = tracker.track(list(it["frames"]), mask, it["key_idx"])
            log(f"stom_train default_tracker() under RGA3_STOM_TRACKER={ct3}, item {it['id']}: "
                f"tracks {tracks.shape}, visible {vis.mean():.3f}, "
                f"{time.perf_counter() - t1:.3f} s")
            if tracks.shape[:1] != (len(frames),) or not tracks.shape[1] or \
                    not np.isfinite(tracks).all():
                raise AssertionError(f"stom_train: default_tracker tracks {tracks.shape}")
    finally:
        if saved_choice is None:
            os.environ.pop("RGA3_STOM_TRACKER", None)
        else:
            os.environ["RGA3_STOM_TRACKER"] = saved_choice
    oracle = dict(zip(("fixed", "serving"), oracle_reports(16, 8)))
    for suite in ("fixed", "serving"):
        t1 = time.perf_counter()
        rep = bench_stom_synth.main(["--weights", ct3, "--suite", suite, "--device", device])
        log(f"stom_train bench_stom_synth --suite {suite} on {os.path.basename(ct3)}: "
            f"{time.perf_counter() - t1:.2f} s; ground-truth oracle {json.dumps(oracle[suite])}")
        errs = [v for k, v in report_numbers(oracle[suite])
                if k.endswith("px_err") and not k.startswith("stayput")]
        finite = all(math.isfinite(v) for _, v in report_numbers(rep))
        if rep["backend"] != "shipped" or not finite or not errs or any(errs):
            raise AssertionError(f"stom_train bench_stom_synth {suite}: {rep}, oracle {errs}")
    launches = {k: v for k, v in read_path()[0].items() if v}
    log(f"stom_train: port kernel launches in the phase: {launches or 'none'}")
    if launches:
        raise AssertionError(f"stom_train: the tracker's training launched {launches}")
    del run1, run2, run3, model1, file_model
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# the demo server at Qwen2.5-VL-7B int4 + Hiera-L, with a 3B draft
# --------------------------------------------------------------------------


def sample_frames(frames, num_frames=None):
    """(frames, indices) as `data.video.load_frames_from_video` samples a
    video's frames: `num_frames` by `get_sparse_indices`, else all."""
    from rga3_tpu_torch.data.templates import get_sparse_indices

    idxs = (get_sparse_indices(len(frames), num_frames) if num_frames is not None
            else list(range(len(frames))))
    return [frames[i] for i in idxs], idxs


def npy_video_loader(path, num_frames=None, sample_fps=None):
    """The server's `load_video` for phase 4c's uploads: an uploaded `.npy`
    of (T, H, W, 3) uint8 frames."""
    import numpy as np

    return (*sample_frames(list(np.load(path)), num_frames), 25.0)


def npy_bytes(arr) -> bytes:
    import io

    import numpy as np

    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def post_multipart(url, fields, files):
    """POST a multipart form; returns the decoded JSON reply."""
    import urllib.request

    boundary = "rga3smokeboundary"
    body = b""
    for k, v in fields.items():
        body += (f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n'
                 f"{v}\r\n").encode()
    for k, (fname, data) in files.items():
        body += (f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"; '
                 f'filename="{fname}"\r\nContent-Type: application/octet-stream\r\n\r\n'
                 ).encode() + data + b"\r\n"
    body += f"--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=600) as r:
        out = json.loads(r.read())
    if "error" in out:
        raise AssertionError(f"{url}: the server answered {out['error']}")
    return out


def first_divergence(chat, a: str, b: str, frames, question) -> str:
    """Where two answers part, with the plain route's top-2 logit margin
    there (over max|logit|), from a teacher-forced pass of the plain
    tokens."""
    import torch

    wa, wb = a.split(), b.split()
    i = next((j for j, (x, y) in enumerate(zip(wa, wb)) if x != y), min(len(wa), len(wb)))
    toks = torch.tensor([[int(w.replace("tok", "")) for w in wa]]) if all(
        w.startswith("tok") for w in wa) else None
    if toks is None or i >= toks.shape[1]:
        return f"answers part at word {i}"
    inputs = chat.prepare([chat.encode(question, video_frames=frames)])
    lg = teacher_forced_logits(chat.model, inputs, toks)[0, i]
    top2 = lg.topk(2).values
    return (f"answers part at token {i}: plain {wa[i]}, other {wb[i]}; the plain route's "
            f"top-2 margin there {(top2[0] - top2[1]).item() / lg.abs().max().item():.3e} "
            f"of max|logit|")


def int4_verify_calls(qwen4, card_line) -> None:
    """The verify's int4 products at M = SERVE_K + 1 on the 7B LM's weights,
    per projection: `int4_matmul` (decode launches of at most
    INT4_DECODE_ROWS rows) against one prefill-tile launch of all the rows
    (`int4_matmul_launch`) and against M = 1, in device ms from CUDA-graph
    replays; both routes against the plain version, and the shipped
    route's rows bit-equal to one-row calls."""
    import torch
    from rga3_tpu_torch.ops import quant as tq

    layer = qwen4.lm.model.layers_0
    mods = {"q_proj": layer.self_attn.q_proj, "k_proj": layer.self_attn.k_proj,
            "o_proj": layer.self_attn.o_proj, "gate_proj": layer.mlp.gate_proj,
            "down_proj": layer.mlp.down_proj, "lm_head": qwen4.lm.lm_head}
    gen = torch.Generator("cuda").manual_seed(0)
    m = SERVE_K + 1
    for name, mod in mods.items():
        q, s = mod.kernel_q4, mod.scale_g
        x = rand((m, mod.in_features), gen)
        y, tile, ref = tq.int4_matmul(x, q, s), tq.int4_matmul_launch(x, q, s), \
            tq.int4_matmul_reference(x, q, s)
        rows = all(torch.equal(y[i], tq.int4_matmul(x[i:i + 1], q, s)[0]) for i in range(m))
        ones = torch.ones(m, dtype=torch.bool, device="cuda")
        rel, rel_t = row_rel_err(y, ref, ones)[0], row_rel_err(tile, ref, ones)[0]
        ms = {label: time_graph(fn, [None], 20) for label, fn in (
            ("M = 1", lambda _: tq.int4_matmul(x[:1], q, s)),
            (f"M = {m} shipped", lambda _: tq.int4_matmul(x, q, s)),
            (f"M = {m} prefill tile", lambda _: tq.int4_matmul_launch(x, q, s)))}
        log(f"serve int4 verify call {name} (in {mod.in_features}, out {mod.out_features}): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
            + f"; row err / max|ref| shipped {rel:.3e}, tile {rel_t:.3e} (tol {ROW_TOL}); "
            f"rows equal to one-row calls: {rows}; {card_line}")
        if not rows or max(rel, rel_t) > ROW_TOL:
            raise AssertionError(f"serve int4 verify call {name}: rows differ from one-row "
                                 "calls or from the plain version")


def serve_phase(frames, seed, card_line, read_path) -> dict:
    """Phase 4c: `python -m rga3_tpu_torch.serve`'s service built by
    `build_service` at Qwen2.5-VL-7B int4 (int8 tower) + SAM2 Hiera-L with
    a bf16 Qwen2.5-VL-3B draft, random weights from the seed; the int4
    UniGR written by `save_quantized` and built again from the directory
    (every tensor bit-equal); then the server on a free localhost port,
    driven over HTTP: /health, /, /api/qa plain, through the target as its
    own draft and through the 3B draft (each answer the direct plain
    greedy answer), four concurrent /api/qa coalesced by the batcher (each
    the direct `answer_batch` answer in the batcher's order), /api/segment
    (the RLEs decode to the direct masks). Each request is a path, its
    launches read after its cold call. Returns the paths."""
    import shutil
    import threading
    import urllib.request

    import numpy as np
    import torch
    from rga3_tpu_torch.evaluation.segmentor import UniGRChat
    from rga3_tpu_torch.ops.attention import reset_launches
    from rga3_tpu_torch.ops.quant import INT4_DECODE_ROWS, save_quantized
    from rga3_tpu_torch.serve.__main__ import build_model, build_service, parse_args
    from rga3_tpu_torch.serve.app import QABatcher, serve
    from rga3_tpu_torch.utils import rle

    paths = {}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    args = parse_args(["--model_dir", "dummy", "--model_size", "7b", "--int4",
                       "--draft_dir", "dummy", "--spec_k", str(SERVE_K), "--seed", str(seed),
                       "--max_new_tokens", str(SERVE_DRAFT_TOKENS)])
    service = build_service(args, load_video=npy_video_loader)
    torch.cuda.synchronize()
    spec3b = service.chat
    model, proc, draft = service.segmentor.model, service.segmentor.processor, spec3b.draft_model
    log(f"serve: build_service (dummy 7B int4 UniGR + Hiera-L, bf16 3B draft of "
        f"{sum(p.numel() for p in draft.parameters()) / 1e9:.3f} B params) "
        f"{time.perf_counter() - t1:.2f} s; {(torch.cuda.memory_allocated() - base) / 2**30:.2f} "
        f"GiB on the card; {card_line}")

    # the pre-quantized route: save, build again from the directory, compare
    qdir = os.path.join(HERE, "build", "serve_quant")
    shutil.rmtree(qdir, ignore_errors=True)
    t1 = time.perf_counter()
    save_quantized(model, qdir, {"bits": 4, "mode": "int4", "arch": "unigr", "source": "dummy"})
    t_save = time.perf_counter() - t1
    size = sum(os.path.getsize(os.path.join(qdir, f)) for f in os.listdir(qdir))
    t1 = time.perf_counter()
    model2, _ = build_model(parse_args(["--model_dir", qdir, "--model_size", "7b"]))
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t1
    sd, sd2 = model.state_dict(), model2.state_dict()
    differ = [k for k in sd if sd2.get(k) is None or sd[k].dtype != sd2[k].dtype
              or not torch.equal(sd[k], sd2[k])]
    n_int = sum(1 for k in sd if not sd[k].is_floating_point())
    log(f"serve: save_quantized {size / 1e9:.3f} GB in {t_save:.2f} s, built again from it in "
        f"{t_load:.2f} s; {len(sd)} tensors ({n_int} int8), {len(differ)} differ")
    if differ or set(sd) != set(sd2):
        raise AssertionError(f"pre-quantized round trip: {differ[:5]} differ")
    del model2, sd2, sd
    shutil.rmtree(qdir)
    torch.cuda.empty_cache()

    upload = {"video": ("frames.npy", npy_bytes(np.stack(frames)))}
    qa_frames = sample_frames(frames, service.max_qa_frames)[0]
    question = "What is happening in this video? Describe it in detail."
    plain = UniGRChat(model, proc, max_new_tokens=SERVE_TOKENS)
    selfd = UniGRChat(model, proc, max_new_tokens=SERVE_TOKENS, draft_model=model.qwen,
                      spec_k=SERVE_K)
    httpd = serve(service, port=0, background=True, host="127.0.0.1")
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/health", timeout=30) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(url + "/", timeout=30) as r:
            index = r.read()
        if health != {"status": "ok"} or b"UniGR" not in index:
            raise AssertionError(f"serve: /health {health}, / {len(index)} bytes")

        def request(name, chat, tokens):
            """Cold request over HTTP (its launches the path `name`), the
            direct plain greedy answer, and the request's answer against it."""
            service.chat = chat
            reset_launches()
            t = time.perf_counter()
            ans = post_multipart(url + "/api/qa", {"question": question}, upload)["answer"]
            wall = time.perf_counter() - t
            paths[name] = read_path()
            launched, calls = paths[name]
            if launched["flash_attention"] <= 0 or launched["int4_matmul"] <= 0:
                raise AssertionError(f"serve {name}: flash or int4 was not launched")
            # the verify's SERVE_K + 1 rows ride in decode launches of at
            # most INT4_DECODE_ROWS (M = 1 is every one-token forward's)
            if chat.draft_model is not None and not any(
                    key[0] == INT4_DECODE_ROWS for key in calls["int4_matmul"]):
                raise AssertionError(f"serve {name}: no int4 launch at M = {INT4_DECODE_ROWS}")
            st = dict(chat.last_stats)
            ref_chat = plain if tokens == SERVE_TOKENS else UniGRChat(
                model, proc, max_new_tokens=tokens)
            t = time.perf_counter()
            ref = ref_chat.answer(question, video_frames=qa_frames)
            direct = time.perf_counter() - t
            emitted = st.get("emitted", st["forwards"])
            ms_tok = st["decode_s"] * 1e3 / max(1, emitted - 1)
            log(f"serve {name}: HTTP {wall:.3f} s (cold), direct plain greedy {direct:.3f} s; "
                f"prefill {st['prefill_s']:.4f} s, {emitted} tokens, decode "
                f"{st['decode_s']:.4f} s = {ms_tok:.3f} ms per token after the first"
                + (f"; {st['steps']} verify steps, {st['draft_forwards']} draft forwards, "
                   f"{st['accepted']} of {SERVE_K * st['steps']} proposals accepted"
                   if "steps" in st else "")
                + f"; launches { {k: n for k, n in paths[name][0].items() if n} }; {card_line}")
            if ans != ref:
                raise AssertionError(f"serve {name}: the answer over HTTP is not the plain "
                                     f"greedy answer; "
                                     + first_divergence(ref_chat, ref, ans, qa_frames, question))
            return wall, direct, ms_tok

        wall, direct, plain_ms = request("serve_qa_plain", plain, SERVE_TOKENS)
        t = time.perf_counter()
        post_multipart(url + "/api/qa", {"question": question}, upload)
        warm_http = time.perf_counter() - t
        t = time.perf_counter()
        plain.answer(question, video_frames=qa_frames)
        warm_direct = time.perf_counter() - t
        log(f"serve: plain /api/qa warm {warm_http:.3f} s over HTTP against {warm_direct:.3f} s "
            f"direct: {(warm_http - warm_direct) * 1e3:.1f} ms of server a request "
            f"({len(upload['video'][1]) / 1e6:.1f} MB upload); {card_line}")
        self_ms = request("serve_qa_self_draft", selfd, SERVE_TOKENS)[2]
        st = selfd.last_stats
        if st["accepted"] != SERVE_K * st["steps"]:
            raise AssertionError(f"serve self-draft: {st['accepted']} of {SERVE_K * st['steps']} "
                                 "proposals accepted; the target as its own draft takes all")
        spec3b_ms = request("serve_qa_3b_draft", spec3b, SERVE_DRAFT_TOKENS)[2]

        # the self-draft's forwards timed one by one (a synchronize after each)
        times = {}

        def timed(mod, name):
            fwd = mod.forward

            def run(*a, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fwd(*a, **kw)
                torch.cuda.synchronize()
                ids = a[0] if a else kw["input_ids"]
                times.setdefault((name, ids.shape[1]), []).append(time.perf_counter() - t)
                return out
            mod.forward = run

        timed(model.qwen, "target")
        try:
            selfd.answer(question, video_frames=qa_frames)
        finally:
            del model.qwen.forward
        med = {key: statistics.median(v) * 1e3 for key, v in times.items() if key[1] <= SERVE_K + 1}
        log("serve: self-draft forwards, synchronized, median ms: "
            + ", ".join(f"M = {m} {v:.2f} ({len(times[('target', m)])}x)"
                        for (_, m), v in sorted(med.items()))
            + f"; ms per token: plain {plain_ms:.3f}, self-draft {self_ms:.3f}, 3B draft "
            f"{spec3b_ms:.3f}; {card_line}")

        int4_verify_calls(model.qwen, card_line)

        # four concurrent requests, coalesced by the batcher
        batcher = QABatcher(plain, max_batch=4, window_ms=SERVE_WINDOW_MS, lock=service.lock)
        taken = []
        answer_batch = plain.answer_batch

        def recorded(questions, **kw):
            taken.append(list(questions))
            return answer_batch(questions, **kw)

        plain.answer_batch = recorded
        service.chat, service.batcher = plain, batcher
        questions = [question, "What color is the largest object?",
                     "How many people are visible?", "Where is the camera pointing?"]
        answers, errors = {}, []

        def ask(q):
            try:
                answers[q] = post_multipart(url + "/api/qa", {"question": q}, upload)["answer"]
            except BaseException as e:  # raised below, in this thread
                errors.append(e)

        reset_launches()
        t = time.perf_counter()
        threads = [threading.Thread(target=ask, args=(q,)) for q in questions]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t
        paths["serve_qa_batch4"] = read_path()
        service.batcher = None
        batcher.close()
        del plain.answer_batch
        if errors:
            raise errors[0]
        t = time.perf_counter()
        ref = plain.answer_batch(taken[0], video_frames_list=[qa_frames] * len(taken[0]))
        direct = time.perf_counter() - t
        log(f"serve batch: 4 concurrent /api/qa in {wall:.3f} s (window {SERVE_WINDOW_MS} ms), "
            f"batch_sizes {batcher.batch_sizes}; direct answer_batch {direct:.3f} s; "
            f"{card_line}")
        if batcher.batch_sizes != [4] or [answers[q] for q in taken[0]] != ref:
            raise AssertionError("serve batch: not coalesced into one answer_batch of 4, or "
                                 "the answers differ from the direct answer_batch")

        # /api/segment: the RLEs against a direct segment_video
        reset_launches()
        t = time.perf_counter()
        out = post_multipart(url + "/api/segment", {"expression": "the person on the left"},
                             upload)
        wall = time.perf_counter() - t
        paths["serve_segment"] = read_path()
        t = time.perf_counter()
        masks = service.segmentor.segment_video(frames, "the person on the left")
        direct = time.perf_counter() - t
        got = np.stack([rle.decode(m) for m in out["masks"]]).astype(bool)
        log(f"serve segment: HTTP {wall:.3f} s (cold), direct segment_video {direct:.3f} s; "
            f"{out['num_frames']} frames, foreground {got.mean():.4f}; launches "
            f"{ {k: n for k, n in paths['serve_segment'][0].items() if n} }; {card_line}")
        if got.shape != masks.shape or not np.array_equal(got, masks):
            raise AssertionError("serve segment: the RLE masks differ from segment_video's")
        missing = [k for k in SEGMENT_KERNELS + ("int4_matmul",)
                   if paths["serve_segment"][0][k] <= 0]
        if missing:
            raise AssertionError(f"serve segment: {missing} not launched")
        log(f"serve: max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"(the phase-3 bf16 UniGR included); {card_line}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    del service, model, draft, spec3b, plain, selfd
    torch.cuda.empty_cache()
    return paths


# --------------------------------------------------------------------------
# a small model on the card against the same weights on the CPU
# --------------------------------------------------------------------------


def small_reference(seed: int) -> None:
    import numpy as np
    import torch
    from rga3_tpu_torch.config import SegHeadConfig
    from rga3_tpu_torch.data.processor import QwenVLProcessor
    from rga3_tpu_torch.evaluation.segmentor import UniGRSegmentor
    from rga3_tpu_torch.models.qwen25vl import tiny_config
    from rga3_tpu_torch.models.sam2.config import tiny_sam2_config
    from rga3_tpu_torch.models.sam2.video import track_video
    from rga3_tpu_torch.models.unigr import UniGR, UniGRConfig
    from rga3_tpu_torch.ops import fused_block as fb
    from rga3_tpu_torch.ops.attention import flash_attention, window_attention
    from rga3_tpu_torch.ops.resize import resize_u8_bicubic_aa

    proc = QwenVLProcessor.from_pretrained(
        "dummy", min_pixels=4 * 28 * 28, max_pixels=64 * 28 * 28,
        video_max_pixels=64 * 28 * 28)
    sam = tiny_sam2_config(128)
    # the fused routes: windows of 16 tokens everywhere (the window kernel's
    # smallest; pooled query windows of 4), and stage 3 (width 64) through
    # the split window block
    sam = sam.replace(hiera=sam.hiera.replace(window_spec=(4, 4, 4, 4),
                                              fused_block_max_dim=32))
    counted = (flash_attention, window_attention, fb.fused_window_block,
               fb.fused_window_block_split, fb.fused_transition_block)
    cfg = UniGRConfig(qwen=tiny_config(152_000), sam2=sam,
                      seg=SegHeadConfig(out_dim=sam.d_model, seg_token_id=proc.seg_token_id))
    cpu = UniGR(cfg, device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(seed), std=0.1)
    gpu = UniGR(cfg, device="cuda", dtype=torch.bfloat16)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, (112, 168, 3), dtype=np.uint8) for _ in range(2)]
    res = {}
    for name, model in (("cpu_f32", cpu), ("gpu_bf16", gpu)):
        seg = UniGRSegmentor(model, proc, num_frames_mllm=2, sam_chunk=2)
        before = [f.launches for f in counted]
        emb, has = seg._seg_embedding(frames, "the thing")
        logits = seg.decode_logits(seg.encode_frames(frames), emb)
        res[name] = (emb.float().cpu(), logits.float().cpu(), has,
                     [f.launches - n for f, n in zip(counted, before)])
    (ec, lc, hc, _), (eg, lg, hg, launched) = res["cpu_f32"], res["gpu_bf16"]
    if not (hc and hg) or min(launched) == 0:
        raise AssertionError(f"small reference: has_seg {hc}/{hg}, launches {launched}")
    emb_rel = ((eg - ec).norm() / ec.norm()).item()
    logit_rel = ((lg - lc).abs().max() / lc.abs().max()).item()
    agree = ((lg > 0) == (lc > 0)).float().mean().item()
    log(f"small reference (tiny UniGR, bf16 on the card vs f32 plain on the CPU): "
        f"[SEG] rel err {emb_rel:.3e}, mask logit max err / max|logit| "
        f"{logit_rel:.3e}, mask agreement {agree:.5f}")
    if not (emb_rel < 5e-2 and logit_rel < 5e-2 and agree > 0.97):
        raise AssertionError("small reference: the card disagrees with the CPU")
    # the tracker on the same models: 2 frames, O = 2, the same prompts and
    # frames on both devices; its 480-key bank takes the dense memory
    # attention on both, so this holds the memory encoder and the bank
    size = sam.image_size
    u8 = resize_u8_bicubic_aa(torch.from_numpy(np.stack(frames)), (size, size))
    lang = torch.stack([ec, ec.flip(0)])[:, None]
    tracks = [track_video(m.grounding_encoder, u8.to(m.device),
                          language_embd=lang.to(m.device, m.dtype), device=m.device)
              for m in (cpu, gpu)]
    (mc, pc), (mg, pg) = ((tr["high_res_masks"].float().cpu(), tr["obj_ptrs"].float().cpu())
                          for tr in tracks)
    for f in range(mc.shape[0]):
        t_rel = ((mg[f] - mc[f]).abs().max() / mc[f].abs().max()).item()
        t_agree = ((mg[f] > 0) == (mc[f] > 0)).float().mean().item()
        p_rel = ((pg[f] - pc[f]).norm() / pc[f].norm()).item()
        log(f"small reference tracker (track_video, O=2), frame {f}: mask logit max err / "
            f"max|logit| {t_rel:.3e}, mask agreement {t_agree:.5f}, obj_ptrs rel err {p_rel:.3e}")
        if not (t_rel < 5e-2 and t_agree > 0.97 and p_rel < 5e-2):
            raise AssertionError("small reference tracker: the card disagrees with the CPU")


def small_legacy_reference(seed: int) -> None:
    """A tiny `UniGRLegacy` (SAM-v1 at 128^2: an 8 x 8 grid in windows of
    3, one global block) in bf16 on the card against the same model in f32
    on the CPU: the [SEG] embedding and the low-resolution mask logits of
    two frames, within the small reference's gates."""
    import numpy as np
    import torch
    from rga3_tpu_torch.config import SegHeadConfig
    from rga3_tpu_torch.data.processor import QwenVLProcessor
    from rga3_tpu_torch.evaluation.segmentor import UniGRSegmentor
    from rga3_tpu_torch.models.qwen25vl import tiny_config
    from rga3_tpu_torch.models.sam1 import tiny_sam1_config
    from rga3_tpu_torch.models.unigr.legacy import UniGRLegacy, UniGRLegacyConfig
    from rga3_tpu_torch.ops.attention import flash_attention

    proc = QwenVLProcessor.from_pretrained(
        "dummy", min_pixels=4 * 28 * 28, max_pixels=64 * 28 * 28,
        video_max_pixels=64 * 28 * 28)
    sam = tiny_sam1_config(128)
    cfg = UniGRLegacyConfig(qwen=tiny_config(152_000), sam1=sam,
                            seg=SegHeadConfig(out_dim=sam.d_model, seg_token_id=proc.seg_token_id))
    cpu = UniGRLegacy(cfg, device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(seed), std=0.1)
    gpu = UniGRLegacy(cfg, device="cuda", dtype=torch.bfloat16)
    gpu.load_state_dict(cpu.state_dict())
    frames = [f for f in np.random.default_rng(seed).integers(0, 256, (2, 112, 168, 3),
                                                              dtype=np.uint8)]
    res = {}
    for name, model in (("cpu_f32", cpu), ("gpu_bf16", gpu)):
        seg = UniGRSegmentor(model, proc, num_frames_mllm=2, sam_chunk=2)
        before = flash_attention.launches
        emb, has = seg._seg_embedding(frames, "the thing")
        logits = seg.decode_logits(seg.encode_frames(frames), emb)
        res[name] = (emb.float().cpu(), logits.float().cpu(), has,
                     flash_attention.launches - before)
    (ec, lc, hc, _), (eg, lg, hg, launched) = res["cpu_f32"], res["gpu_bf16"]
    emb_rel = ((eg - ec).norm() / ec.norm()).item()
    logit_rel = ((lg - lc).abs().max() / lc.abs().max()).item()
    agree = ((lg > 0) == (lc > 0)).float().mean().item()
    log(f"small legacy reference (tiny UniGRLegacy, bf16 on the card vs f32 plain on the "
        f"CPU): [SEG] rel err {emb_rel:.3e}, low-res mask logit max err / max|logit| "
        f"{logit_rel:.3e}, mask agreement {agree:.5f}; flash launches on the card {launched}")
    if not (hc and hg and launched > 0 and emb_rel < 5e-2 and logit_rel < 5e-2
            and agree > 0.97):
        raise AssertionError("small legacy reference: the card disagrees with the CPU")


def teacher_forced_logits(model, inputs, tokens):
    """(B, steps, V) f32 logits of `model` on the prompt `inputs` (as
    `UniGRChat.prepare` gives them) followed by `tokens`, through a fresh
    KV cache: the prefill's head on each row's last prompt position, then
    one one-token decode step per token but the last."""
    import torch
    from rga3_tpu_torch.models.qwen25vl.language import make_kv_cache

    dev = model.device
    ids, mask = inputs["input_ids"].to(dev), inputs["attention_mask"].to(dev)
    b, l = ids.shape
    n = tokens.shape[1]
    cache = make_kv_cache(model.cfg.text, b, l + n, dtype=model.dtype, device=dev)
    pp = inputs["pixel_patches"]
    with torch.no_grad():
        out = model(ids, position_ids=inputs["position_ids"].to(dev),
                    segment_ids=mask.int(), pixel_patches=None if pp is None else pp.to(dev),
                    vision_layout=inputs["vision_layout"], cache=cache,
                    logits_indices=mask.sum(1) - 1)
        steps = [out["logits"][:, 0].float()]
        next_pos = mask.sum(1) + inputs["rope_deltas"].to(dev)
        for i in range(n - 1):
            pos = (next_pos + i)[None, :, None].expand(3, b, 1)
            out = model(tokens[:, i:i + 1].to(dev), position_ids=pos, cache=cache)
            steps.append(out["logits"][:, -1].float())
    return torch.stack(steps, 1)


def small_chat_reference(seed: int) -> None:
    """A tiny int4 serving model (int4 LM, int8 tower) on the card in bf16
    against the same quantized model in f32 on the CPU: prefill and
    teacher-forced decode logits, per step within CHAT_TOL of max|logit|."""
    import numpy as np
    import torch
    from rga3_tpu_torch.data.processor import QwenVLProcessor
    from rga3_tpu_torch.evaluation.segmentor import UniGRChat
    from rga3_tpu_torch.models.qwen25vl import tiny_config
    from rga3_tpu_torch.models.qwen25vl.generate import greedy_generate
    from rga3_tpu_torch.models.qwen25vl.model import Qwen25VL
    from rga3_tpu_torch.ops.quant import int4_matmul, quantize_for_serving

    proc = QwenVLProcessor.from_pretrained(
        "dummy", min_pixels=4 * 28 * 28, max_pixels=64 * 28 * 28,
        video_max_pixels=64 * 28 * 28)
    cpu = Qwen25VL(tiny_config(152_000), device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif name.endswith("weight") and p.dim() == 1:
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.1, generator=gen)
    quantize_for_serving(cpu, "int4")
    gpu = Qwen25VL(cpu.cfg, device="cuda", dtype=torch.bfloat16)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, (112, 168, 3), dtype=np.uint8) for _ in range(2)]
    chat = UniGRChat(cpu, proc, max_new_tokens=8)
    inputs = chat.prepare([chat.encode("What is shown in this video?", frames)])
    kw = dict(max_new_tokens=8, eos_token_id=EOS, pad_token_id=PAD)
    toks_c, lg_c = greedy_generate(cpu, **inputs, return_logits=True, **kw)
    before = int4_matmul.launches
    lg_g = teacher_forced_logits(gpu, inputs, toks_c[:, :lg_c.shape[1]])
    toks_g = greedy_generate(gpu, **inputs, **kw)
    launched = int4_matmul.launches - before
    rel = ((lg_g.cpu() - lg_c).abs().amax(-1) / lg_c.abs().amax(-1)).max().item()
    log(f"small chat reference (tiny int4 serving model, bf16 on the card vs f32 on the "
        f"CPU, teacher-forced): logits max err / max|logit| {rel:.3e} over "
        f"{lg_c.shape[1]} steps; int4_matmul launches {launched}; greedy tokens CPU "
        f"{toks_c[0].tolist()} card {toks_g[0].tolist()}")
    if not (rel < CHAT_TOL and launched > 0 and torch.isfinite(lg_g).all()):
        raise AssertionError("small chat reference: the card disagrees with the CPU")


def int4_lm_bytes(model) -> int:
    """Bytes of the int4 LM's packed weights and scales: what one decode
    step must read at the least."""
    from rga3_tpu_torch.models.qwen25vl.language import QuantLinear

    return sum(m.kernel_q4.numel() + 4 * m.scale_g.numel()
               for m in model.modules() if isinstance(m, QuantLinear) and m.bits == 4)


def log_chat(label: str, chat, wall: float) -> float:
    """Log a chat call's prefill, tokens and decode ms per token; return the
    ms per token."""
    st = chat.last_stats
    steps = max(1, st["forwards"] - 1)
    ms_tok = st["decode_s"] * 1e3 / steps
    log(f"chat {label}: {wall:.3f} s; prefill {st['prefill_s']:.4f} s; "
        f"{st['forwards']} tokens chosen ({st['forwards']} forwards); decode "
        f"{st['decode_s']:.4f} s, {ms_tok:.3f} ms per token")
    return ms_tok


def chat_phase(model, proc, frames, read_path) -> dict:
    """Phase 4 on the bf16 UniGR `model`: float chat, the int4 serving copy
    (cold with its launches asserted, warm, traced, answer_batch of 4), the
    cache check and the int8 options. Returns the chat paths' (launches,
    calls), each read by `read_path()` right after its cold call, and the
    int4 chat (for phase 4b)."""
    import torch
    from rga3_tpu_torch.evaluation.segmentor import UniGRChat
    from rga3_tpu_torch.models.qwen25vl.generate import greedy_generate
    from rga3_tpu_torch.ops.attention import reset_launches
    from rga3_tpu_torch.ops.quant import quantize_for_serving, set_config_flags

    dev = model.device
    paths = {}
    question = "What is happening in this video? Describe it in detail."
    chat = UniGRChat(model, proc, max_new_tokens=CHAT_TOKENS)
    reset_launches()
    t1 = time.perf_counter()
    answer = chat.answer(question, video_frames=frames)
    paths["chat_float"] = read_path()
    log_chat("float (bf16 weights, bf16 KV cache), cold", chat, time.perf_counter() - t1)
    t1 = time.perf_counter()
    chat.answer(question, video_frames=frames)
    float_ms_tok = log_chat("float, warm", chat, time.perf_counter() - t1)
    log(f"chat float: answer of {len(answer.split())} words; launches "
        f"{ {k: n for k, n in paths['chat_float'][0].items() if n} }")
    if paths["chat_float"][0]["flash_attention"] <= 0:
        raise AssertionError("float chat: flash_attention was not launched")
    inputs = chat.prepare([chat.encode(question, video_frames=frames)])
    gkw = dict(max_new_tokens=CHAT_TOKENS, eos_token_id=EOS, pad_token_id=PAD)
    # the float prefill's logits, against which the quantized models' are logged
    _, float_steps = greedy_generate(model.qwen, **inputs, return_logits=True,
                                     **{**gkw, "max_new_tokens": 1})

    t1 = time.perf_counter()
    qwen4 = quantize_for_serving(copy.deepcopy(model.qwen), "int4")
    torch.cuda.synchronize()
    lm_bytes = int4_lm_bytes(qwen4)
    tok_bound_ms = lm_bytes / PEAK_BYTES * 1e3
    log(f"int4 serving copy (int4 LM, int8 vision tower), quantized on the card in "
        f"{time.perf_counter() - t1:.2f} s; int4 LM weights + scales {lm_bytes / 1e9:.3f} GB, "
        f"a decode step's bound {tok_bound_ms:.3f} ms at {PEAK_BYTES / 1e12} TB/s")
    chat4 = UniGRChat(qwen4, proc, max_new_tokens=CHAT_TOKENS)
    per_forward = 7 * qwen4.cfg.text.num_hidden_layers + 1
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t1 = time.perf_counter()
    answer4 = chat4.answer(question, video_frames=frames)
    paths["chat_int4"] = read_path()
    log_chat("int4 serving, cold", chat4, time.perf_counter() - t1)
    forwards = chat4.last_stats["forwards"]
    n4 = paths["chat_int4"][0]["int4_matmul"]
    log(f"chat int4: answer of {len(answer4.split())} words; int4_matmul launches {n4} = "
        f"{per_forward} x {forwards} forwards; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the bf16 UniGR included); "
        f"launches { {k: n for k, n in paths['chat_int4'][0].items() if n} }")
    if n4 != per_forward * forwards or paths["chat_int4"][0]["flash_attention"] <= 0:
        raise AssertionError(f"int4 chat: {n4} int4_matmul launches for {forwards} forwards")
    t1 = time.perf_counter()
    chat4.answer(question, video_frames=frames)
    warm4 = time.perf_counter() - t1
    ms_tok = log_chat("int4 serving, warm", chat4, warm4)
    log(f"chat int4: {ms_tok:.3f} ms per token against the {tok_bound_ms:.3f} ms bound "
        f"({tok_bound_ms / ms_tok:.3f} of it); float {float_ms_tok:.3f} ms per token")
    # the trace's post-processing grows with its events: trace a 16-token
    # answer, against the same answer untraced
    chat16 = UniGRChat(qwen4, proc, max_new_tokens=16)
    t1 = time.perf_counter()
    chat16.answer(question, video_frames=frames)
    warm16 = time.perf_counter() - t1
    log_chat("int4 serving, 16 new tokens, warm", chat16, warm16)
    busy = device_breakdown(lambda: chat16.answer(question, video_frames=frames))
    log(f"profile (int4 chat, 16 new tokens): device busy in the traced call / wall of the "
        f"untraced warm call: {busy:.1f} / {warm16 * 1e3:.1f} ms = {busy / (warm16 * 1e3):.3f}")
    questions = [question, "What color is the largest object?",
                 "How many people are visible?", "Where is the camera pointing?"]
    reset_launches()
    t1 = time.perf_counter()
    answers = chat4.answer_batch(questions, video_frames_list=[frames] * 4)
    paths["chat_int4_batch4"] = read_path()
    log_chat("int4 serving, answer_batch of 4", chat4, time.perf_counter() - t1)
    batch_launches = paths["chat_int4_batch4"][0]
    if len(answers) != 4 or batch_launches["flash_attention"] <= 0 or (
            batch_launches["int4_matmul"] != per_forward * chat4.last_stats["forwards"]):
        raise AssertionError("int4 answer_batch: wrong answers or launches")

    # KV-cached decode against one forward without a cache over the prompt
    # and the tokens it chose (pads segment 0; decode positions next_pos + i)
    toks, steps = greedy_generate(qwen4, **inputs, return_logits=True, **gkw)
    n = steps.shape[1]
    ids, mask = inputs["input_ids"].to(dev), inputs["attention_mask"].to(dev)
    lens = mask.sum(1)
    full = torch.cat([ids, toks[:, :n - 1]], 1)
    segs = torch.cat([mask, torch.ones_like(toks[:, :n - 1])], 1)
    gen_pos = (lens + inputs["rope_deltas"].to(dev))[:, None] + torch.arange(n - 1, device=dev)
    fpos = torch.cat([inputs["position_ids"].to(dev), gen_pos[None].expand(3, 1, n - 1)], 2)
    with torch.no_grad():
        nocache = qwen4(full, position_ids=fpos, segment_ids=segs,
                        pixel_patches=inputs["pixel_patches"].to(dev),
                        vision_layout=inputs["vision_layout"])["logits"][0].float()
    at = torch.cat([lens - 1, ids.shape[1] + torch.arange(n - 1, device=dev)])
    rows = nocache[at]
    scale = rows.abs().amax(-1)
    err = (steps[0] - rows).abs().amax(-1) / scale
    top2 = rows.topk(2, -1).values
    decided = (top2[:, 0] - top2[:, 1]) > CHAT_TOL * scale
    agree = (toks[0, :n] == rows.argmax(-1))[decided]
    log(f"cache check (int4, {n} steps): decode logits vs no-cache forward, max err / "
        f"max|logit| {err.max().item():.3e} (tol {CHAT_TOL}); tokens equal to the no-cache "
        f"argmax at {int(agree.sum())} of {int(decided.sum())} steps whose top-2 margin "
        f"exceeds the tolerance")
    if not (err.max().item() <= CHAT_TOL and bool(agree.all())):
        raise AssertionError("KV-cached decode disagrees with the forward without a cache")
    rel4 = ((steps[0, 0] - float_steps[0, 0]).abs().max() / float_steps[0, 0].abs().max()).item()
    log(f"int4 vs float prefill logits (same weights, quantized): max err / max|logit| {rel4:.3e}")
    del chat16, nocache, rows, steps
    torch.cuda.empty_cache()

    # the int8 options: int8 LM and tower, W8A8 prefill, int8 KV cache
    t1 = time.perf_counter()
    qwen8 = copy.deepcopy(model.qwen)
    set_config_flags(qwen8, {"quant_w8a8": True, "kv_cache_int8": True}, {"quant_w8a8": True})
    quantize_for_serving(qwen8, "int8")
    chat8 = UniGRChat(qwen8, proc, max_new_tokens=16)
    chat8.answer(question, video_frames=frames)
    log_chat("int8 options (int8 LM + tower, W8A8 prefill, int8 KV cache), cold", chat8,
             time.perf_counter() - t1)
    t1 = time.perf_counter()
    _, steps8 = greedy_generate(qwen8, **{**gkw, "max_new_tokens": 16}, **inputs,
                                return_logits=True)
    rel8 = ((steps8[0, 0] - float_steps[0, 0]).abs().max() / float_steps[0, 0].abs().max()).item()
    log(f"int8 options vs float prefill logits: max err / max|logit| {rel8:.3e}; "
        f"16-token generate {time.perf_counter() - t1:.3f} s")
    if not torch.isfinite(steps8).all():
        raise AssertionError("int8 options: non-finite logits")
    del qwen8, chat8, steps8, float_steps
    torch.cuda.empty_cache()
    return paths, chat4


def train_batch(frames, cfg, seed, model_device):
    """A release micro-batch on the smoke's video, through the port's
    processor and `collate`: B = 2 samples with questions of two lengths
    and [SEG] answers, right-padded to 512 tokens; the video at up to
    TRAIN_VIDEO_TOKENS merged tokens a sample, padded to that budget; T =
    TRAIN_SAM_FRAMES uint8 SAM frames at the SAM resolution; random 0/1 gt
    masks at the video's size. Returns the train_forward keyword arguments,
    on the card."""
    import numpy as np
    import torch
    from rga3_tpu_torch.data.collate import TrainSample, collate
    from rga3_tpu_torch.data.processor import ChatMessage, QwenVLProcessor
    from rga3_tpu_torch.ops.resize import resize_u8_bicubic_aa

    unit = cfg.qwen.vision.merge_unit
    proc = QwenVLProcessor.from_pretrained(
        "dummy", video_max_pixels=TRAIN_VIDEO_TOKENS // 4 * 28 * 28)
    rng = np.random.default_rng(seed + 1)
    size = cfg.sam2.image_size
    idx = np.linspace(0, len(frames) - 1, TRAIN_SAM_FRAMES).round().astype(int)
    sam = resize_u8_bicubic_aa(torch.from_numpy(np.stack([frames[i] for i in idx])),
                               (size, size)).numpy()
    dialogues = [
        ("Please segment the person on the left in this video.",
         "Sure, the person on the left is [SEG] . They walk toward the camera, stop near "
         "the door and turn to look at the street."),
        ("Can you segment the red car that is moving away from the camera, behind the "
         "trees on the far side of the road?", "It is [SEG] ."),
    ]
    samples = [TrainSample(
        sample_id=str(i),
        messages=[ChatMessage("user", [{"type": "video"}, {"type": "text", "text": q}]),
                  ChatMessage("assistant", [{"type": "text", "text": a}])],
        video_frames=frames, sam_frames=sam,
        gt_masks=(rng.random((TRAIN_SAM_FRAMES,) + frames[0].shape[:2]) > 0.5).astype(np.float32),
    ) for i, (q, a) in enumerate(dialogues)]
    c = collate(samples, proc, cfg.qwen, pad_to_multiple=512,
                vision_budget_tokens=len(samples) * TRAIN_VIDEO_TOKENS * unit)
    dev = model_device
    batch = {k: torch.as_tensor(c[k], device=dev) for k in (
        "input_ids", "labels", "position_ids", "images_sam", "gt_masks", "masks_valid",
        "pixel_patches")}
    batch["segment_ids"] = torch.as_tensor(c["attention_mask"], device=dev).int()
    batch["vision_layout"] = {k: torch.as_tensor(v, device=dev)
                              for k, v in c["vision_layout"].items()}
    log(f"train batch: input_ids {tuple(c['input_ids'].shape)}, text lengths "
        f"{c['attention_mask'].sum(1).tolist()}, supervised tokens "
        f"{(c['labels'] != -100).sum(1).tolist()}, video grids {c['video_grid_thw']}, "
        f"pixel_patches {tuple(c['pixel_patches'].shape)} (budget "
        f"{len(samples) * TRAIN_VIDEO_TOKENS} merged tokens), images_sam "
        f"{tuple(c['images_sam'].shape)} {c['images_sam'].dtype}, gt_masks "
        f"{tuple(c['gt_masks'].shape)}")
    return batch


def compare_grads(grads, refs):
    """(per-tensor relative L2 sorted worst first, the largest key-bias
    gradient relative to its key weights', the relative L2 of all the
    gradients as one vector) of `grads` against `refs`. A key bias shifts
    every logit of a softmax row alike, so its exact gradient is zero and
    both sides hold rounding noise: it is held to its weights' gradient
    norm instead."""
    import torch

    rels, key_bias, diff2, ref2 = [], 0.0, 0.0, 0.0
    for n, gr in refs.items():
        g = grads[n]
        if gr is None or g is None:
            if (gr is None) != (g is None):
                raise AssertionError(f"train: {n} has a gradient on one side only")
            continue
        if not torch.isfinite(g).all():
            raise AssertionError(f"train: non-finite gradient of {n}")
        d2 = (g.float() - gr.float()).square().sum().item()
        r2 = gr.float().square().sum().item()
        diff2, ref2 = diff2 + d2, ref2 + r2
        if n.endswith("k_proj.bias"):
            scale = refs[n[:-len("bias")] + "weight"].float().norm().item()
            key_bias = max(key_bias, max(g.float().norm().item(), r2 ** 0.5) / scale)
            continue
        rels.append(((d2 / max(r2, 1e-60)) ** 0.5, n))
    rels.sort(reverse=True)
    return rels, key_bias, (diff2 / ref2) ** 0.5


def train_phase(model, frames, seed, read_path) -> dict:
    """The UniGR train step at the model's width (`build_train_step`, remat
    "none", the release trainable set; TrainConfig with a one-step warmup)
    on one fixed batch: TRAIN_STEPS steps, the first (cold, at lr 0) with the
    launch counts reset before it and read after it, then one traced step;
    checks the losses, the frozen and trainable weights, the launches, and
    the kernel route's gradients against the plain route's on the same
    weights and batch. Returns the path's (launches, calls)."""
    import torch
    from rga3_tpu_torch.config import TrainConfig
    from rga3_tpu_torch.ops import attention as tatt
    from rga3_tpu_torch.ops.attention import reset_launches, set_plain_attention
    from rga3_tpu_torch.train.step import build_train_step, make_train_state

    flash_bwd_kernel = tatt.flash_attention_bwd

    cfg = model.cfg
    batch = train_batch(frames, cfg, seed, model.device)
    # a one-step warmup (max(1, int(20 * 0.03))): the first update's lr is 0,
    # the later ones ~lr
    tcfg = TrainConfig(epochs=1, steps_per_epoch=20, grad_accum_steps=1)
    state, opt = make_train_state(tcfg, model)
    n_train = sum(p.numel() for p in opt.params.values())
    t0 = time.perf_counter()
    before = {n: bits_digest(p) for n, p in model.named_parameters()}
    log(f"train: {n_train / 1e9:.4f} B trainable parameters in {len(opt.params)} tensors "
        f"(LoRA r={cfg.qwen.text.lora_rank} alpha={cfg.qwen.text.lora_alpha}, lm_head, "
        f"embed_tokens, sam_mask_decoder, text_hidden_fcs); Adam mu {tcfg.adam_mu_dtype}, "
        f"nu in the parameters' dtype; checksums of {len(before)} weights in "
        f"{time.perf_counter() - t0:.2f} s")
    step = build_train_step(lambda m, mb: m.train_forward(**mb), opt, timed=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    losses, walls, path = [], [], None
    for i in range(TRAIN_STEPS):
        if i == 0:
            reset_launches()
        t1 = time.perf_counter()
        state, aux = step(state, [batch])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        if i == 0:
            path = read_path()
        losses.append({k: float(v) for k, v in aux.items()})
        sec = step.seconds
        log(f"train step {i + 1} ({'cold' if i == 0 else 'warm'}): {walls[-1]:.3f} s; forward "
            f"{sec['forward']:.3f}, backward {sec['backward']:.3f}, optimizer "
            f"{sec['optimizer']:.3f} s; lr {aux['lr']:.3e}, grad norm {aux['grad_norm']:.4f}; "
            + ", ".join(f"{k} {losses[-1][k]:.5f}" for k in (
                "loss", "ce_loss", "mask_bce_loss", "mask_dice_loss")))
    peak = torch.cuda.max_memory_allocated()
    launches = path[0]
    per_step = cfg.qwen.text.num_hidden_layers + cfg.sam2.twoway_depth
    log(f"train: launches of the cold step {({k: n for k, n in launches.items() if n})}; "
        f"flash_attention_bwd {launches['flash_attention_bwd']} (the LM's "
        f"{cfg.qwen.text.num_hidden_layers} layers + the decoder's {cfg.sam2.twoway_depth} "
        f"image->token attentions = {per_step}); max_memory_allocated {peak / 2**30:.2f} GiB "
        f"(the bf16 UniGR included), {(peak - resident) / 2**30:.2f} GiB above the resident")
    for k in TRAIN_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"train: {k} was not launched")
    if launches["flash_attention_bwd"] != per_step:
        raise AssertionError(f"train: {launches['flash_attention_bwd']} flash backward launches, "
                             f"expected {per_step}")
    if not all(math.isfinite(v) for row in losses for v in row.values()):
        raise AssertionError("train: non-finite loss")
    if not losses[-1]["loss"] < losses[0]["loss"]:
        raise AssertionError(f"train: the loss did not fall ({losses[0]['loss']} -> "
                             f"{losses[-1]['loss']})")
    t0 = time.perf_counter()
    moved, frozen_same, frozen = [], 0, 0
    for n, p in model.named_parameters():
        same = bits_digest(p) == before[n]
        if n in opt.params:
            moved.append((n, not same))
        else:
            frozen += 1
            frozen_same += same
    must_move = [n for n, m in moved if not m and "sam_mask_decoder" not in n]
    n_moved = sum(m for _, m in moved)
    log(f"train: frozen tensors bit-identical {frozen_same} of {frozen}; trainable tensors "
        f"moved {n_moved} of {len(moved)} (those of the decoder that the loss does not reach "
        f"stay); compared in {time.perf_counter() - t0:.2f} s")
    if frozen_same != frozen or must_move:
        raise AssertionError(f"train: frozen weights changed or trainable ones stayed: "
                             f"{must_move[:5]}")
    del before
    # where a warm step's device time goes: one more step, traced
    warm = statistics.median(walls[1:])
    busy = device_breakdown(lambda: step(state, [batch]))
    log(f"profile (train step): device busy in the traced step / median wall of the untraced "
        f"warm steps: {busy:.1f} / {warm * 1e3:.1f} ms = {busy / (warm * 1e3):.3f}")

    # the kernel route against the plain route on the same weights and batch,
    # and against the same route with only the flash backward plain
    def loss_and_grads():
        for p in opt.params.values():
            p.grad = None
        out = model.train_forward(**batch)
        out["loss"].backward()
        grads = {n: p.grad for n, p in opt.params.items()}
        for p in opt.params.values():
            p.grad = None
        return out["loss"].item(), grads

    loss_k, grads_k = loss_and_grads()
    # the run-to-run spread of the kernel route: the same backward again
    # (the masks' bilinear resizes add with atomics in their backward)
    loss_k2, grads_k2 = loss_and_grads()
    rel_s, _, glob_s = compare_grads(grads_k2, grads_k)
    spread = (glob_s, rel_s[0][0])
    del grads_k2
    log(f"train: kernel route against itself, same weights and batch: loss {loss_k2:.6f} vs "
        f"{loss_k:.6f} (bit-equal {loss_k2 == loss_k}); all trainable gradients as one vector "
        f"rel L2 {glob_s:.3e}, worst tensor {rel_s[0][1]} {rel_s[0][0]:.3e}")
    if loss_k2 != loss_k:
        raise AssertionError("train: the kernel route's forward is not deterministic")
    set_plain_attention(model, True)
    loss_p, grads_p = loss_and_grads()
    # the plain route upstream of a kernel-route decoder: the decoder's code
    # differs from the plain route's in nothing, what its gradients differ
    # by comes from the rounding upstream (the LM, the vision tower, Hiera)
    set_plain_attention(model.grounding_encoder.sam_mask_decoder, False)
    _, grads_u = loss_and_grads()
    set_plain_attention(model, False)
    tatt.flash_attention_bwd = tatt.flash_attention_bwd_reference
    try:
        loss_b, grads_b = loss_and_grads()
    finally:
        tatt.flash_attention_bwd = flash_bwd_kernel
    rel_p, key_p, glob_p = compare_grads(grads_k, grads_p)
    rel_b, key_b, _ = compare_grads(grads_k, grads_b)
    decoder = [n for n in grads_p if ".sam_mask_decoder." in n]
    rel_u = compare_grads({n: grads_u[n] for n in decoder}, {n: grads_k[n] for n in decoder})[0]
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)

    def worst(rels):
        return ", ".join(f"{n} {r:.3e}" for r, n in rels[:3]) + (
            f"; median {statistics.median(r for r, _ in rels):.3e} over {len(rels)} tensors")

    log(f"train: kernel route vs plain route (every call site plain), same weights and batch: "
        f"loss {loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.3e}, tol {LOSS_TOL}); all trainable "
        f"gradients as one vector rel L2 {glob_p:.3e} (tol {GRAD_TOL}); per tensor, worst: "
        f"{worst(rel_p)}")
    log(f"train: the mask decoder's gradients, kernel route vs plain route upstream of the "
        f"same kernel-route decoder, worst: {worst(rel_u)}")
    log(f"train: kernel route vs the same route with the plain flash backward "
        f"(flash_attention_bwd_reference on the same o and LSE): loss {loss_b:.6f}; per tensor "
        f"rel L2 (tol {GRAD_TOL}), worst: {worst(rel_b)}; key biases (exact gradient 0) at most "
        f"{max(key_p, key_b):.3e} of their weights' gradient")
    if (loss_rel > LOSS_TOL or glob_p > GRAD_TOL or rel_b[0][0] > GRAD_TOL
            or max(key_p, key_b) > GRAD_TOL or loss_b != loss_k):
        raise AssertionError("train: the kernel route's gradients disagree with the plain route")
    frozen_sec, frozen_wall = dict(step.seconds), walls[-1]
    del grads_p, grads_u, grads_b, opt, state, step
    torch.cuda.empty_cache()
    paths = {"train": path}
    paths.update(unfrozen_step(model, batch, tcfg, loss_k, grads_k, spread, frozen_sec,
                               frozen_wall, peak - resident, read_path))
    del grads_k, batch
    torch.cuda.empty_cache()
    return paths


def unfrozen_step(model, batch, tcfg, frozen_loss, frozen_grads, spread, frozen_sec,
                  frozen_wall, frozen_extra, read_path) -> dict:
    """Phase 6's unfrozen step: the same model with `freeze_sam_backbone`
    off, on the same weights and batch as `frozen_loss` and `frozen_grads`
    (the kernel route's loss and trainable gradients): the loss bit-equal
    to the frozen one, the image encoder's gradients (non-zero in every
    Hiera stage and the neck), the trainable gradients within
    UNFROZEN_SPREADS times the frozen route's own run-to-run `spread` (rel
    L2 of all of them as one vector, of the worst tensor), then one timed
    step (lr fixed at the config's, so
    that the trainable tensors move) leaving the encoder's weights
    bit-identical; its seconds and its peak memory above the resident beside
    the frozen steps' (`frozen_extra` bytes). Returns its path."""
    import torch
    from rga3_tpu_torch.ops.attention import reset_launches
    from rga3_tpu_torch.train.step import build_train_step, make_train_state

    frozen_cfg = model.cfg
    model.cfg = frozen_cfg.replace(seg=frozen_cfg.seg.replace(freeze_sam_backbone=False))
    try:
        state, opt = make_train_state(tcfg, model)
        encoder = opt.grad_only
        opt.zero_grad()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        out = model.train_forward(**batch)
        out["loss"].backward()
        torch.cuda.synchronize()
        path = read_path()
        grads = {n: p.grad for n, p in opt.params.items()}
        ends = list(itertools.accumulate(frozen_cfg.sam2.hiera.stages))
        reached = set()  # the Hiera stages (0-based) and "neck" with a non-zero gradient
        for n, p in encoder.items():
            if p.grad is None or not torch.isfinite(p.grad).all():
                raise AssertionError(f"train unfrozen: {n} has no finite gradient")
            if p.grad.abs().max() > 0:
                block = re.search(r"\.trunk\.blocks_(\d+)\.", n)
                if block is not None:
                    reached.add(sum(int(block.group(1)) >= e for e in ends))
                elif ".neck." in n:
                    reached.add("neck")
        rel, _, glob = compare_grads(grads, frozen_grads)
        n_enc = sum(p.numel() for p in encoder.values())
        loss = out["loss"].item()
        tol = [UNFROZEN_SPREADS * x for x in spread]
        log(f"train unfrozen (freeze_sam_backbone=False), same weights and batch: loss "
            f"{loss:.6f} vs the frozen {frozen_loss:.6f} (bit-equal {loss == frozen_loss}); "
            f"{len(encoder)} image encoder tensors ({n_enc / 1e6:.1f} M elements) take "
            f"gradients, non-zero in {sorted(reached, key=str)} (stages 0-{len(ends) - 1}, "
            f"the neck); trainable gradients against the frozen step's: as one vector rel L2 "
            f"{glob:.3e} (tol {tol[0]:.3e} = {UNFROZEN_SPREADS} x the frozen route's spread), "
            f"worst tensor {rel[0][1]} {rel[0][0]:.3e} (tol {tol[1]:.3e})")
        if loss != frozen_loss:
            raise AssertionError("train unfrozen: the loss differs from the frozen step's")
        if ({*range(len(ends)), "neck"} - reached) or glob > tol[0] or rel[0][0] > tol[1]:
            raise AssertionError("train unfrozen: the encoder's gradients do not reach every "
                                 "stage, or the trainable gradients differ from the frozen "
                                 "step's by more than its own run-to-run spread")
        opt.zero_grad()
        del out, grads
        # one step: the trainable tensors move, the encoder stays
        before = {n: bits_digest(p) for n, p in encoder.items()}
        moved_before = {n: bits_digest(p) for n, p in opt.params.items()}
        opt.schedule = lambda count: tcfg.lr
        step = build_train_step(lambda m, mb: m.train_forward(**mb), opt, timed=True)
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        state, aux = step(state, [batch])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        extra = torch.cuda.max_memory_allocated() - resident
        same = sum(bits_digest(p) == before[n] for n, p in encoder.items())
        moved = sum(bits_digest(p) != moved_before[n] for n, p in opt.params.items())
        sec = step.seconds
        log(f"train unfrozen step: {wall:.3f} s (forward {sec['forward']:.3f}, backward "
            f"{sec['backward']:.3f}, optimizer {sec['optimizer']:.3f}) against the frozen "
            f"step's {frozen_wall:.3f} s (forward {frozen_sec['forward']:.3f}, backward "
            f"{frozen_sec['backward']:.3f}, optimizer {frozen_sec['optimizer']:.3f}); "
            f"peak memory {extra / 2**30:.2f} GiB above the resident against "
            f"{frozen_extra / 2**30:.2f}; "
            f"loss {float(aux['loss']):.5f}; encoder tensors bit-identical after the update "
            f"{same} of {len(encoder)}, trainable tensors moved {moved} of {len(opt.params)}")
        if same != len(encoder) or not moved or not math.isfinite(float(aux["loss"])):
            raise AssertionError("train unfrozen: the optimizer touched the encoder, or moved "
                                 "nothing")
    finally:
        model.cfg = frozen_cfg
        for p in model.grounding_encoder.image_encoder.parameters():
            p.requires_grad_(False)
            p.grad = None
    del state, opt, step
    return {"train_unfrozen": path}


def bits_digest(t) -> int:
    """A position-sensitive checksum of a tensor's bits, on its device:
    sum over elements of bits x (index mod 65521 + 1) in wrapping int64."""
    import torch

    flat = t.detach().reshape(-1).view(torch.int16 if t.element_size() == 2 else torch.int32)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    chunk = 1 << 26
    for i in range(0, flat.numel(), chunk):
        c = flat[i:i + chunk].to(torch.int64)
        w = torch.arange(i, i + c.numel(), device=t.device, dtype=torch.int64) % 65521 + 1
        total += (c * w).sum()
    return int(total)


def assemble_once(assemble, draws, model, workers=8, keep=lambda key: False,
                  skip=lambda key: False):
    """`train.__main__.assemble_params` as the train CLI's `build` calls it,
    whose draws a second call copies: the first call keeps a host copy of
    every tensor it fills (and of what `keep` returned) in `draws`; a later
    call that finds every tensor it would fill there, with the model's
    shape and dtype, copies them instead of drawing (the same values)."""
    import torch

    todo = {k: t for k, t in model.state_dict().items() if not skip(k)}
    if todo and all(k in draws and draws[k][0].shape == t.shape and draws[k][0].dtype == t.dtype
                    for k, t in todo.items()):
        with torch.no_grad():
            for k, t in todo.items():
                t.copy_(draws[k][0])
        return {k: draws[k][1] for k in todo if keep(k) and draws[k][1] is not None}
    kept = assemble(model, workers=workers, keep=keep, skip=skip)
    for k, t in todo.items():
        draws[k] = (t.detach().to("cpu", copy=True), kept.get(k))
    return kept


class CountedStep:
    """A train step that resets the launch counts before its first call and
    reads the path after it (the entry point's cold step)."""

    def __init__(self, step, read_path, out):
        self.step, self.read_path, self.out = step, read_path, out

    @property
    def seconds(self):
        return self.step.seconds

    def __call__(self, state, micro_batches):
        import torch
        from rga3_tpu_torch.ops.attention import reset_launches

        first = "path" not in self.out
        if first:
            reset_launches()
        out = self.step(state, micro_batches)
        if first:
            torch.cuda.synchronize()
            self.out["path"] = self.read_path()
        return out


def train_cli_phase(seed: int, card_line: str, read_path):
    """`python -m rga3_tpu_torch.train`'s `main` at the release config on a
    synthetic tree: one epoch, then an auto-resumed second (see the module
    docstring, 6b), under a process group of one rank over NCCL, which it
    tears down after. Works under build/train_cli/ and deletes it. Returns
    the cold step's path (launches, calls) and the export read back (the
    state dict phase 6c's reference is built from)."""
    import socket

    import torch
    import torch.distributed as dist
    from rga3_tpu_torch.parallel import init_distributed

    # one rank over NCCL: the CLI joins this group, and every collective of
    # its step, checkpoint and val runs (copies at world size 1)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    init_distributed(f"127.0.0.1:{port}", num_processes=1, process_id=0)
    log(f"train cli: process group {dist.get_backend()} world size {dist.get_world_size()} "
        f"on cuda:{torch.cuda.current_device()}, init {time.perf_counter() - t0:.3f} s")
    try:
        return _train_cli_runs(seed, card_line, read_path)
    finally:
        dist.destroy_process_group()


def _train_cli_runs(seed: int, card_line: str, read_path):
    """Phase 6b's two runs of the CLI (see `train_cli_phase`)."""
    import gc
    import shutil

    import torch
    from rga3_tpu_torch.config import TrainConfig
    from rga3_tpu_torch.tools.synth_trees import write_train_tree
    from rga3_tpu_torch.train import __main__ as cli
    from rga3_tpu_torch.train import checkpoints
    from rga3_tpu_torch.train.optimizer import lr_schedule
    from rga3_tpu_torch.utils.profiling import mfu, peak_flops_per_chip

    work = os.path.join(HERE, "build", "train_cli")
    shutil.rmtree(work, ignore_errors=True)
    data, ckpt = os.path.join(work, "data"), os.path.join(work, "ckpt")
    with open(RELEASE_CONFIG) as f:
        release = json.load(f)
    names, rates = release["dataset"].split(","), release["sample_rates"].split(",")
    try:
        import cv2

        log(f"train cli: OpenCV {cv2.__version__} writes and decodes the videoqa mp4")
    except ImportError:
        keep = [i for i, n in enumerate(names) if n != "videoqa"]
        names, rates = [names[i] for i in keep], [rates[i] for i in keep]
        log("train cli: no OpenCV on this machine: videoqa dropped from the mixture "
            f"({len(names)} datasets)")
    t0 = time.perf_counter()
    write_train_tree(data, names, seed, TRAIN_CLI_SIZES)
    n_files = sum(len(f) for _, _, f in os.walk(data))
    n_bytes = sum(os.path.getsize(os.path.join(d, x)) for d, _, fs in os.walk(data) for x in fs)
    log(f"train cli: tree of {len(names)} datasets ({','.join(names)}) at {TRAIN_CLI_SIZES}: "
        f"{n_files} files, {n_bytes / 1e6:.1f} MB in {time.perf_counter() - t0:.2f} s")
    base = ["--config", RELEASE_CONFIG, "--model_dir", "dummy", "--model_size", TRAIN_CLI_MODEL,
            "--mesh_data", "1",
            "--dataset_dir", data, "--ckpt_dir", ckpt, "--dataset", ",".join(names),
            "--sample_rates", ",".join(rates), "--steps_per_epoch", "1", "--data_workers", "2",
            "--val_at_start", "--val_samples", str(TRAIN_CLI_SIZES["val_images"])]
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train cli: memory_allocated before the CLI {torch.cuda.memory_allocated() / 2**30:.2f} "
        "GiB")

    def report(tag, run, wall):
        for st in run["steps"]:
            accum = len(run["last_micro_batches"])
            ph = st["phases"]
            log(f"train cli {tag}: step (batch {st['batch_idx']}) {st['seconds']:.3f} s, a "
                f"micro-batch {(ph['forward'] + ph['backward']) / accum:.3f} s (forward "
                f"{ph['forward']:.3f}, backward {ph['backward']:.3f}, optimizer "
                f"{ph['optimizer']:.3f} s over {accum}, of which the reductions over the "
                f"ranks {ph['collectives']:.3f} s); host {st['host']:.3f} s for the "
                f"accumulation batch, wait on the loader {st['loader_wait']:.3f} s; lr "
                f"{st['aux']['lr']:.3e}, grad norm {st['aux']['grad_norm']:.4f}; " + ", ".join(
                    f"{k} {st['aux'][k]:.5f}" for k in cli.METERS))
        for label, scores, sec in run["val"]:
            log(f"train cli {tag}: val {label}: gIoU {scores['gIoU']:.5f} cIoU "
                f"{scores['cIoU']:.5f} over {scores['n']} images in {sec:.3f} s")
        for sec, nbytes in run["save"]:
            log(f"train cli {tag}: checkpoint saved, {nbytes / 1e9:.3f} GB in {sec:.2f} s "
                f"({nbytes / 1e9 / sec:.2f} GB/s)")
        if run["restore"]:
            sec, nbytes = run["restore"]
            log(f"train cli {tag}: checkpoint restored, {nbytes / 1e9:.3f} GB in {sec:.2f} s")
        log(f"train cli {tag}: {wall:.2f} s of main; {run['trainable'] / 1e9:.4f} B trainable "
            f"parameters; peak memory {run['peak_bytes'] / 2**30:.2f} GiB; {card_line}")
        for st in run["steps"]:
            if not all(math.isfinite(v) for v in st["aux"].values()):
                raise AssertionError(f"train cli {tag}: non-finite loss {st['aux']}")

    # run 1: the cold step's launches are the path's
    cold = {}
    real_build = cli.build_train_step
    cli.build_train_step = lambda *a, **k: CountedStep(real_build(*a, **k), read_path, cold)
    # the two runs draw the same --model_dir dummy parameters: run 2 copies
    # run 1's (the resume restores the trainable ones from the checkpoint)
    real_assemble = cli.assemble_params
    draws = {}
    cli.assemble_params = lambda *a, **k: assemble_once(real_assemble, draws, *a, **k)
    try:
        t0 = time.perf_counter()
        run1 = cli.main(base + ["--epochs", "1", "--loss_log", os.path.join(work, "loss1.json")])
        wall1 = time.perf_counter() - t0
    finally:
        cli.build_train_step = real_build
    report("run 1", run1, wall1)
    accum = len(run1["last_micro_batches"])
    cfg = run1["state"].model.cfg
    launches, calls = cold["path"]
    lm_d = cfg.qwen.text.head_dim
    vit_d = cfg.qwen.vision.hidden_size // cfg.qwen.vision.num_heads
    by_d = {}
    for key, (n, segs) in calls["flash_attention"].items():
        d = key[0][-1]
        seg = segs is not None and any(x is not None for x in segs)
        by_d[(d, seg)] = by_d.get((d, seg), 0) + n
    # under f32 parameters SAM2 computes in f32 (`cli.hold_f32`): its decoder's
    # attention takes the f32 flash forward and recomputes its plain version
    # for the backward, so the bf16 backward runs the LM's layers only
    per_mb = cfg.qwen.text.num_hidden_layers
    log(f"train cli: launches of the cold step {({k: n for k, n in launches.items() if n})}; "
        f"flash forward by (head dim, segment ids): {by_d}; flash_attention_bwd "
        f"{launches['flash_attention_bwd']} (expected {accum} micro-batches x {per_mb})")
    # the LM attends with segment ids (its padding), the ViT's full layers too
    # (its frames' windows)
    if not by_d.get((lm_d, True)) or not by_d.get((vit_d, True)):
        raise AssertionError(f"train cli: the LM (D={lm_d}) or the ViT (D={vit_d}) flash "
                             f"forward with segment ids was not launched: {by_d}")
    # the f32 encoder (Hiera-L and the decoder's image attention) on the f32
    # kernels, none of Hiera's bf16 launches, per micro-batch
    f32_want = dict(HIERA_L_F32_LAUNCHES)
    f32_want["flash_attention_f32"] += cfg.sam2.twoway_depth
    log("train cli: the f32 encoder's launches a cold step, per kernel: " + ", ".join(
        f"{k} {launches[k]} ({f32_want[k]} x {accum} expected)" for k in F32_KERNELS)
        + f"; the bf16 Hiera kernels' {({k: launches[k] for k in HIERA_L_LAUNCHES})}")
    for k, n in f32_want.items():
        if launches[k] != n * accum:
            raise AssertionError(f"train cli: {k}: {launches[k]} launches, expected {n} x {accum}")
    if any(launches[k] for k in HIERA_L_LAUNCHES) or launches["window_attention"]:
        raise AssertionError("train cli: the f32 encoder launched bf16 Hiera kernels")
    if launches["flash_attention_bwd"] != accum * per_mb:
        raise AssertionError(f"train cli: {launches['flash_attention_bwd']} flash backward "
                             f"launches, expected {accum * per_mb}")
    t0 = time.perf_counter()
    saved = {n: bits_digest(t) for n, t in checkpoints.state_tensors(run1["state"]).items()}
    log(f"train cli: checksums of {len(saved)} saved tensors in {time.perf_counter() - t0:.2f} s")
    count1, step1 = run1["state"].opt.count, run1["state"].step
    loss1 = run1["steps"][0]["aux"]["loss"]
    del run1
    gc.collect()
    torch.cuda.empty_cache()

    # run 2: auto-resume at epoch 1, one more step
    seen = {}

    def on_restore(state):
        seen["count"], seen["step"] = state.opt.count, state.step
        seen["digest"] = {n: bits_digest(t) for n, t in checkpoints.state_tensors(state).items()}

    try:
        t0 = time.perf_counter()
        run2 = cli.main(base + ["--epochs", "2", "--loss_log", os.path.join(work, "loss2.json")],
                        on_restore=on_restore)
        wall2 = time.perf_counter() - t0
    finally:
        cli.assemble_params = real_assemble
        draws.clear()
    report("run 2", run2, wall2)
    state = run2["state"]
    st = run2["steps"][0]
    want_lr = lr_schedule(TrainConfig(lr=release["lr"], epochs=2, steps_per_epoch=1))(1)
    same = sum(seen["digest"].get(n) == d for n, d in saved.items())
    with open(os.path.join(ckpt, "meta_log_info.json")) as f:
        meta = json.load(f)
    log(f"train cli: resumed at epoch {run2['start_epoch']}; restored tensors equal to the "
        f"saved ones {same} of {len(saved)} (names {set(seen['digest']) == set(saved)}); count "
        f"{count1} -> restored {seen['count']} -> {state.opt.count}, step {step1} -> "
        f"{seen['step']} -> {state.step}; lr {st['aux']['lr']:.6e} (schedule at step 1 "
        f"{want_lr:.6e}); batch index {st['batch_idx']}; losses {loss1:.5f}, "
        f"{st['aux']['loss']:.5f}; meta_log_info {meta}")
    if (run2["start_epoch"] != 1 or same != len(saved) or set(seen["digest"]) != set(saved)
            or (seen["count"], seen["step"]) != (count1, step1) or count1 != 1
            or state.opt.count != 2 or st["aux"]["lr"] != want_lr or st["batch_idx"] != 1):
        raise AssertionError("train cli: the resume did not continue the run")
    metrics = [h["metric"] for h in meta.get("history", [])]
    if (meta.get("last_epoch") != 1 or [h["epoch"] for h in meta["history"]] != [0, 1]
            or meta["best_metric"] != max(metrics)
            or meta["best_epoch"] != meta["history"][metrics.index(max(metrics))]["epoch"]):
        raise AssertionError(f"train cli: meta_log_info.json {meta}")

    # "dots" against "none" on one micro-batch of the run, on the same weights
    mbs = run2["last_micro_batches"]
    lm = state.model.qwen.lm.model
    peaks = {}
    for mode in ("none", "dots"):
        lm.remat = mode
        state.opt.zero_grad()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state.model.train_forward(**mbs[0])["loss"].backward()
        torch.cuda.synchronize()
        peaks[mode] = ((torch.cuda.max_memory_allocated() - resident) / 2**30,
                       time.perf_counter() - t0, resident / 2**30)
    lm.remat = "dots"
    state.opt.zero_grad()
    peaks["unfrozen f32"] = unfrozen_f32_peak(state, mbs[0])
    log("train cli: one micro-batch (input_ids "
        f"{tuple(mbs[0]['input_ids'].shape)}), forward + backward: " + "; ".join(
            f"remat {m}: peak {p:.2f} GiB above the resident {r:.2f} GiB, {sec:.3f} s"
            if p is not None else f"remat {m}: {sec}"
            for m, (p, sec, r) in peaks.items()) + f"; {card_line}")
    # where a warm step's device time goes: the CLI's own step (its loss
    # normalisers and aux all-reduced, the gradients synced over the ranks),
    # one step untraced, one traced
    step = run2["step"]
    t0 = time.perf_counter()
    step(state, mbs)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    found = {}
    busy = device_breakdown(lambda: step(state, mbs), match="nccl", found=found)
    nccl_ms, nccl_n = found["nccl"]
    log(f"profile (train cli step, {accum} micro-batches): device busy in the traced step / "
        f"wall of the untraced warm step: {busy:.1f} / {warm * 1e3:.1f} ms = "
        f"{busy / (warm * 1e3):.3f}; the step's collectives (NCCL kernels, world size "
        f"{run2['mesh'].size}): {nccl_ms:.3f} ms over {nccl_n} launches, "
        f"{step.seconds['collectives']:.4f} s on the host clock with the device synced "
        f"(the aux and gradient reductions); {card_line}")
    flops = cli.step_flops(cfg, mbs)
    log(f"train cli: warm step {flops / 1e12:.3f} TFLOP of model FLOPs "
        f"(unigr_train_step_flops over its {accum} micro-batches) in {warm:.3f} s (with the "
        f"encoder in bf16, before f32 parameters held it in f32: {BF16_ENCODER_WARM_STEP} s, "
        f"PERF.md §5): "
        f"{flops / warm / 1e12:.1f} TFLOP/s, MFU {mfu(flops, warm):.4f} of the "
        f"{peak_flops_per_chip() / 1e12:.0f} TFLOP/s bf16 peak; {card_line}")
    # the checkpoints were read back above: their disk goes to the export
    shutil.rmtree(ckpt)
    exported = export_run(state, card_line)
    del run2, state, mbs, lm, step
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    return {"train_cli": cold["path"]}, exported


def unfrozen_f32_peak(state, mb):
    """One micro-batch forward + backward of phase 6b's model with
    `freeze_sam_backbone` off: under f32 parameters the Hiera-L encoder
    takes gradients through its f32 plain versions, recomputed block by
    block. Returns (GiB above the resident, seconds, resident GiB), or
    (None, the out-of-memory message, resident GiB) when it does not fit
    on the card (logged, not raised: the encoder stays f32)."""
    import gc

    import torch

    model = state.model
    encoder = model.grounding_encoder.image_encoder
    frozen_cfg = model.cfg
    model.cfg = frozen_cfg.replace(seg=frozen_cfg.seg.replace(freeze_sam_backbone=False))
    try:
        for p in encoder.parameters():
            p.requires_grad_(True)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            model.train_forward(**mb)["loss"].backward()
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            msg = f"out of memory on the card: {str(e).splitlines()[0]}"
            log(f"train cli: the unfrozen f32 encoder's micro-batch does not fit: {msg}")
            return None, msg, resident / 2**30
        sec = time.perf_counter() - t0
        grads = [p.grad for p in encoder.parameters()]
        if any(g is None or not torch.isfinite(g).all() for g in grads):
            raise AssertionError("train cli: the unfrozen f32 encoder has no finite gradient")
        if next(encoder.parameters()).dtype != torch.float32:
            raise AssertionError("train cli: the encoder is not f32")
        return ((torch.cuda.max_memory_allocated() - resident) / 2**30, sec, resident / 2**30)
    finally:
        model.cfg = frozen_cfg
        for p in encoder.parameters():
            p.requires_grad_(False)
            p.grad = None
        state.opt.zero_grad()
        gc.collect()
        torch.cuda.empty_cache()


def kernel_wrappers() -> dict:
    """{name: wrapper} of every kernel wrapper whose launches and calls the
    paths record."""
    from rga3_tpu_torch.ops import fused_block as fb
    from rga3_tpu_torch.ops.attention import (
        flash_attention, flash_attention_bwd, flash_attention_f32, window_attention,
        window_attention_f32,
    )
    from rga3_tpu_torch.ops.quant import int4_matmul

    wrappers = {"flash_attention": flash_attention, "window_attention": window_attention,
                "int4_matmul": int4_matmul, "flash_attention_bwd": flash_attention_bwd,
                "window_attention_f32": window_attention_f32,
                "flash_attention_f32": flash_attention_f32}
    wrappers.update((name, getattr(fb, name)) for name in SEGMENT_KERNELS[2:])
    wrappers.update((name, getattr(fb, name)) for name in F32_KERNELS[:3])
    return wrappers


def launch_snapshot():
    """(launches, calls) of every kernel wrapper since the last reset: a
    snapshot, since later calls add to the wrappers' records. Every path
    (phase 6d's ranks too) is read through it."""
    wrappers = kernel_wrappers()
    return ({k: f.launches for k, f in wrappers.items()},
            {k: {key: tuple(rec) for key, rec in f.shapes.items()} for k, f in wrappers.items()})


def tensor_configs(size: str, layers: int, seg_token_id: int):
    """(phase 6d's Qwen2.5-VL config, its UniGR config with the release
    LoRA): `size`'s widths, the LM cut to `layers`."""
    from rga3_tpu_torch.config import SegHeadConfig
    from rga3_tpu_torch.models.sam2.config import Sam2Config, tiny_sam2_config
    from rga3_tpu_torch.models.unigr import UniGRConfig
    from rga3_tpu_torch.tools.generate_ranks import lm_config

    qcfg = lm_config(size, layers)
    if size == "tiny":  # 8 query heads: int4's row blocks need 32 packed rows a rank
        qcfg = qcfg.replace(text=qcfg.text.replace(num_attention_heads=8))
    lora = qcfg.replace(text=qcfg.text.replace(lora_rank=128, lora_alpha=256.0))
    scfg = tiny_sam2_config() if size == "tiny" else Sam2Config()
    return qcfg, UniGRConfig(qwen=lora, sam2=scfg,
                             seg=SegHeadConfig(out_dim=scfg.d_model, seg_token_id=seg_token_id))


def tensor_runs(mesh, job: dict, device, refs=None) -> dict:
    """Phase 6d's work on one rank of `mesh` (this process alone: a mesh of
    one rank): seeded greedy generation in bf16 and int4 and the logits
    under teacher forcing on `refs` (the one-rank tokens; its own without),
    then TP_TRAIN_STEPS train steps of the seeded UniGR on `job["batch"]`;
    each run's kernel launches and calls (counts reset before it), seconds
    and peak memory."""
    import torch
    from rga3_tpu_torch.config import TrainConfig
    from rga3_tpu_torch.models.qwen25vl.generate import greedy_generate
    from rga3_tpu_torch.models.unigr import UniGR
    from rga3_tpu_torch.ops.attention import reset_launches
    from rga3_tpu_torch.parallel.distributed import GLOO_CUDA_VIA_ALL_REDUCE
    from rga3_tpu_torch.parallel.fsdp import shard_model
    from rga3_tpu_torch.tools.generate_ranks import (
        build_seeded, fill_seeded, prompt_inputs, teacher_forced,
    )
    from rga3_tpu_torch.train.optimizer import DEFAULT_TRAINABLE_PATTERNS
    from rga3_tpu_torch.train.step import build_train_step, make_train_state

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    qcfg, ucfg = tensor_configs(job["size"], job["layers"], job["seg_token_id"])
    out = {}
    for mode, bits in (("bf16", None), ("int4", 4)):
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        reset_launches()
        model = build_seeded(qcfg, mesh, job["seed"], device, bits=bits)
        kw = prompt_inputs(TP_BATCH, TP_PROMPT, job["seed"], qcfg.text.vocab_size)
        stats = {}
        tokens = greedy_generate(model, **kw, max_new_tokens=TP_NEW, eos_token_id=-1,
                                 pad_token_id=0, stats=stats)
        ref = tokens.cpu() if refs is None else refs[mode]
        logits = teacher_forced(model, kw["input_ids"], ref)
        sync()
        out[mode] = {"tokens": tokens.cpu(), "logits": logits.cpu(), "stats": stats,
                     "path": launch_snapshot(),
                     "peak": torch.cuda.max_memory_allocated(device) if cuda else 0,
                     "held": sum(t.numel() * t.element_size()
                                 for t in model.state_dict().values())}
        del model, logits
        if cuda:
            torch.cuda.empty_cache()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    model = UniGR(ucfg, device="meta", dtype=torch.bfloat16)
    shard_model(model, mesh, device=device,
                trainable=lambda n: any(p in n for p in DEFAULT_TRAINABLE_PATTERNS))
    fill_seeded(model, job["seed"], device)
    state, opt = make_train_state(TrainConfig(lr=TP_LR), model, master_dtype=torch.float32,
                                  mesh=mesh if mesh.groups else None)
    opt.schedule = lambda count: TP_LR  # the first step moves the weights too
    step = build_train_step(lambda m, mb: m.train_forward(**mb), opt, timed=True,
                            replicas=mesh.replicas(None))
    batch = {k: (v.to(device) if isinstance(v, torch.Tensor)
                 else {a: b.to(device) for a, b in v.items()}) for k, v in job["batch"].items()}
    plan = getattr(model, "shard_plan", None)
    ids = torch.unique(job["batch"]["input_ids"])

    def trainables():
        """{name: f32 value} of the trainable tensors, whole (gathered over
        tensor), except the vocabulary-sharded ones: of those the rows of
        the batch's ids that this rank holds, {name: (ids, rows)}."""
        got = {}
        for n in sorted(opt.params):
            v = opt.full(n).detach()
            if n.endswith(VOCAB_ROWS):
                lo, per = 0, v.shape[0]
                if n in opt.tensor_sharded:
                    parts, index = plan.blocks[n].tensor
                    per = plan.blocks[n].full_shape[0] // parts
                    lo = index * per
                mine = ids[(ids >= lo) & (ids < lo + per)]
                got[n] = (mine, v[mine.to(v.device) - lo].to("cpu", torch.float32, copy=True))
            else:
                got[n] = opt.whole(n, v).to("cpu", torch.float32, copy=True)
        return got

    before = trainables()
    reset_launches()
    losses, seconds = [], []
    for _ in range(TP_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, aux = step(state, [batch])
        losses.append({k: float(v) for k, v in aux.items()})
        sync()
        seconds.append(time.perf_counter() - t0)
    path = launch_snapshot()
    after = trainables()
    moves = {n: ((v[0], v[1] - before[n][1]) if isinstance(v, tuple) else v - before[n])
             for n, v in after.items()}
    # the tensors every tensor rank holds whole, as bytes: equal on every rank
    replicated = hashlib.sha256()
    for n in sorted(opt.params):
        if n not in opt.tensor_sharded:
            replicated.update(opt.full(n).detach().float().cpu().numpy().tobytes())
    out["train"] = {"losses": losses, "seconds": seconds, "path": path,
                    "peak": torch.cuda.max_memory_allocated(device) if cuda else 0,
                    "tensor_sharded": sorted(opt.tensor_sharded),
                    "partial": len(opt.partial), "moves": moves,
                    "replicated": replicated.hexdigest()}
    out["gloo_cuda_via_all_reduce"] = dict(GLOO_CUDA_VIA_ALL_REDUCE)
    del state, opt, model, step
    if cuda:
        torch.cuda.empty_cache()
    return out


def _moved(obj, device):
    """`obj` (tuples, lists and dicts of tensors) with its tensors as numpy
    arrays (`device` None), or its numpy arrays as tensors on `device`:
    phase 6d's recorded calls cross processes by value (a torch tensor
    would travel as a handle to the sender's memory, which closes with
    it)."""
    import numpy as np
    import torch

    if device is None and isinstance(obj, torch.Tensor):
        return obj.cpu().numpy()
    if device is not None and isinstance(obj, np.ndarray):
        return torch.from_numpy(obj).to(device)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_moved(x, device) for x in obj)
    if isinstance(obj, dict):
        return {k: _moved(v, device) for k, v in obj.items()}
    return obj


def _tensor_rank(rank: int, port: int, job: dict, out) -> None:
    """One of phase 6d's two ranks: a process on this card joining a gloo
    group of two (NCCL refuses two ranks on one card); puts its results."""
    import traceback

    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist

    try:
        from rga3_tpu_torch.config import MeshConfig
        from rga3_tpu_torch.parallel import init_distributed, make_mesh

        device = torch.device(job["device"])
        init_distributed(f"127.0.0.1:{port}", 2, rank, device=device,
                         backend="gloo" if device.type == "cuda" else None)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = make_mesh(MeshConfig(tensor=2))
        res = tensor_runs(mesh, job, device, refs=job["refs"])
        if rank != 0:
            # rank 0's logits and whole tensors stand for both (every rank
            # gathers them whole); each rank's own vocabulary rows travel
            for mode in ("bf16", "int4"):
                res[mode]["logits"] = None
            res["train"]["moves"] = {n: m for n, m in res["train"]["moves"].items()
                                     if isinstance(m, tuple)}
        out.put((rank, "ok", _moved(res, None)))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def train_moves(one: dict, results: dict) -> dict:
    """{name: (the two ranks' move, one rank's)} of phase 6d's trainable
    tensors over its train steps, f32 on the host: rank 0's whole tensors;
    the vocabulary-sharded ones at the batch's rows, rank 0's rows then
    rank 1's."""
    import torch

    out = {}
    for n, w in one["train"]["moves"].items():
        got = [_moved(results[r]["train"]["moves"].get(n), "cpu") for r in (0, 1)]
        if isinstance(w, tuple):
            ids = torch.cat([got[0][0], got[1][0]])
            if not torch.equal(ids, w[0]):
                raise AssertionError(f"tensor train: {n}: the ranks' rows are not the batch's")
            out[n] = (torch.cat([got[0][1], got[1][1]]), w[1])
        else:
            out[n] = (got[0], w)
    return out


def tensor_phase(seed: int, frames, device: str = "cuda", size: str = "7b",
                 layers: int = TP_LAYERS) -> dict:
    """Phase 6d: the tensor axis on one card (see the module docstring).
    Returns the two ranks' rank-0 paths (launches, calls) by name."""
    import multiprocessing as mp
    import queue as queue_mod
    import socket

    import numpy as np
    import torch
    from rga3_tpu_torch.config import MeshConfig
    from rga3_tpu_torch.data.processor import QwenVLProcessor
    from rga3_tpu_torch.parallel.mesh import Mesh
    from rga3_tpu_torch.train.optimizer import DEFAULT_TRAINABLE_PATTERNS

    proc = QwenVLProcessor.from_pretrained("dummy")
    _, ucfg = tensor_configs(size, layers, proc.seg_token_id)
    batch = train_batch(frames, ucfg, seed, "cpu")
    job = {"size": size, "layers": layers, "seed": seed, "seg_token_id": proc.seg_token_id,
           "batch": batch, "device": device}
    dev = torch.device(device)
    t0 = time.perf_counter()
    one = tensor_runs(Mesh(MeshConfig(), np.zeros((1, 1, 1), dtype=int)), job, dev)
    log(f"tensor: one rank (LM cut to {layers} of 28 layers at {size} width): "
        + "; ".join(f"{m} peak {one[m]['peak'] / 2**30:.2f} GiB, held "
                    f"{one[m]['held'] / 1e9:.3f} GB, prefill {one[m]['stats']['prefill_s']:.3f} s, "
                    f"decode {one[m]['stats']['decode_s']:.3f} s" for m in ("bf16", "int4"))
        + f"; train losses {[round(x['loss'], 6) for x in one['train']['losses']]}, "
        f"steps {[round(x, 3) for x in one['train']['seconds']]} s, peak "
        f"{one['train']['peak'] / 2**30:.2f} GiB; {time.perf_counter() - t0:.2f} s")
    job["refs"] = {m: one[m]["tokens"] for m in ("bf16", "int4")}
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_tensor_rank, args=(r, port, job, out), daemon=True)
             for r in range(2)]
    for p in procs:
        p.start()
    results = {}
    try:
        while len(results) < 2:
            try:
                rank, status, value = out.get(timeout=600)
            except queue_mod.Empty:
                raise AssertionError("tensor: a rank gave no result in 600 s") from None
            if status != "ok":
                raise AssertionError(f"tensor: rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    log(f"tensor: two ranks over gloo on one card, {time.perf_counter() - t0:.2f} s "
        f"(spawn included); collectives of CUDA tensors through an all-reduce: "
        f"{results[0]['gloo_cuda_via_all_reduce']}")
    paths = {}
    for r in (0, 1):
        for run in ("bf16", "int4", "train"):
            results[r][run]["path"] = _moved(results[r][run]["path"], dev)
        for mode in ("bf16", "int4"):
            results[r][mode] = _moved(results[r][mode], "cpu")
    for mode in ("bf16", "int4"):
        ref, got = one[mode], results[0][mode]
        scale = ref["logits"].abs().amax(-1, keepdim=True)
        err = ((got["logits"] - ref["logits"]).abs() / scale).amax().item()
        top2 = ref["logits"].topk(2, -1).values
        clear = (top2[..., 0] - top2[..., 1]) > TP_TOL * scale[..., 0]
        # the teacher-forced picks (both sides read the one-rank tokens);
        # the ranks' own greedy tokens part from it after a close step
        agree = bool((got["logits"].argmax(-1) == ref["logits"].argmax(-1))[clear].all())
        same = [torch.equal(results[r][mode]["tokens"], ref["tokens"]) for r in (0, 1)]
        launches = got["path"][0]
        log(f"tensor {mode}: teacher-forced logits max err / max|logit| {err:.3e} "
            f"(tol {TP_TOL}); steps with a clear top-2 gap {clear.float().mean().item():.3f}, "
            f"teacher-forced picks equal there {agree}, greedy tokens all equal (rank 0, 1) "
            f"{same}; ranks' held "
            f"{[round(results[r][mode]['held'] / 1e9, 3) for r in (0, 1)]} GB (one rank "
            f"{ref['held'] / 1e9:.3f}), peak "
            f"{[round(results[r][mode]['peak'] / 2**30, 2) for r in (0, 1)]} GiB; prefill {got['stats']['prefill_s']:.3f} s, decode "
            f"{got['stats']['decode_s']:.3f} s (one rank {ref['stats']['decode_s']:.3f}); "
            f"launches {dict((k, v) for k, v in launches.items() if v)}")
        if not (err <= TP_TOL and agree and torch.isfinite(got["logits"]).all()):
            raise AssertionError(f"tensor {mode}: the two ranks disagree with one rank")
        paths[f"tensor2_{mode}"] = got["path"]
    ref, got = one["train"], results[0]["train"]
    losses = [[x["loss"] for x in results[r]["train"]["losses"]] for r in (0, 1)]
    want = [x["loss"] for x in ref["losses"]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[0], want))
    norms = [[x["grad_norm"] for x in results[r]["train"]["losses"]] for r in (0, 1)]
    want_norms = [x["grad_norm"] for x in ref["losses"]]
    norm_rel = max(abs(a - b) / abs(b) for a, b in zip(norms[0], want_norms))
    moves, by_kind = train_moves(one, results), {}
    for n, (m, w) in moves.items():
        by_kind.setdefault(next(p for p in DEFAULT_TRAINABLE_PATTERNS if p in n), []).append(
            (n, m.flatten(), w.flatten()))

    def rel_l2(m, w):
        return ((m - w).norm() / w.norm()).item() if w.norm() > 0 else float(m.norm() > 0)

    # the LM's tensors one by one; the heads after it (SAM2's decoder,
    # text_hidden_fcs) as one vector each, since some of their gradients
    # are rounding noise by construction (an attention key bias's is zero)
    move_err = {}
    for kind, items in by_kind.items():
        if kind in TP_MOVE_WHOLE:
            move_err[kind] = (rel_l2(torch.cat([m for _, m, _ in items]),
                                     torch.cat([w for _, _, w in items])), f"{len(items)} tensors")
        else:
            move_err[kind] = max((rel_l2(m, w), n) for n, m, w in items)
    same = results[0]["train"]["replicated"] == results[1]["train"]["replicated"]
    log(f"tensor train: losses {losses[0]} on both ranks {losses[0] == losses[1]}, one rank "
        f"{want}, max rel diff {rel:.3e} (tol {TP_LOSS_RTOL}); grad norms {norms[0]}, one "
        f"rank {want_norms}, max rel diff {norm_rel:.3e} (tol {TP_NORM_RTOL}); each "
        f"trainable tensor's move against one rank's, relative L2, the largest by kind "
        f"({len(moves)} tensors; tol {TP_MOVE_TOL}, {TP_HEAD_MOVE_TOL} for "
        f"{'/'.join(TP_MOVE_WHOLE)} as one vector each): "
        + ", ".join(f"{k} {e:.3e} ({n})" for k, (e, n) in sorted(move_err.items()))
        + f"; the tensors whole over tensor bit-equal on both ranks {same}; steps "
        f"{[round(x, 3) for x in got['seconds']]} s (one rank "
        f"{[round(x, 3) for x in ref['seconds']]}); peak "
        f"{[round(results[r]['train']['peak'] / 2**30, 2) for r in (0, 1)]} GiB (one rank "
        f"{ref['peak'] / 2**30:.2f}); tensor-sharded {got['tensor_sharded']}, "
        f"{got['partial']} LoRA factors summed over tensor; launches "
        f"{dict((k, v) for k, v in got['path'][0].items() if v)}")
    if not (losses[0] == losses[1] and norms[0] == norms[1] and same
            and rel <= TP_LOSS_RTOL and norm_rel <= TP_NORM_RTOL
            and all(e <= (TP_HEAD_MOVE_TOL if k in TP_MOVE_WHOLE else TP_MOVE_TOL)
                    for k, (e, _) in move_err.items())
            and all(math.isfinite(x) for x in losses[0])):
        raise AssertionError("tensor train: the two ranks disagree with one rank")
    paths["tensor2_train"] = got["path"]
    # the ranks' paths went through the kernels
    for name, need in (("tensor2_bf16", ("flash_attention",)),
                       ("tensor2_int4", ("flash_attention", "int4_matmul")),
                       ("tensor2_train", ("flash_attention", "flash_attention_bwd"))):
        for k in need:
            if paths[name][0][k] <= 0:
                raise AssertionError(f"{name}: {k} was not launched")
    return paths


def second_card_check(seed: int) -> None:
    """Phase 2 on a machine with more than one card: one launch of each
    kernel on cuda:1, with PyTorch's current device left at 0 (the library
    must follow the tensors), against its plain version there; raises on a
    difference beyond SECOND_CARD_TOL of the plain output's largest
    value."""
    import torch
    from rga3_tpu_torch.ops import attention as att
    from rga3_tpu_torch.ops import fused_block as fb
    from rga3_tpu_torch.ops import quant as tq

    dev = torch.device("cuda", 1)
    gen = torch.Generator(dev).manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    with torch.cuda.device(0), torch.no_grad():
        q, k, v, do = (rn(1, 256, 4, 128) for _ in range(4))
        o, lse = att.mha_reference(q, k, v, causal=True, return_lse=True)
        o = o.to(torch.bfloat16)
        w = rn(1, 256, 2, 72)
        x, wt, bias = rn(512, 256), rn(384, 256), rn(384)
        g, beta, pool_x = rn(256), rn(256), rn(2, 256, 64)
        q4, s4 = tq.quantize_int4(rn(256, 384).float())
        xi = rn(3, 256)
        calls = {
            "flash_attention": (att.flash_attention(q, k, v, causal=True),
                                att.mha_reference(q, k, v, causal=True)),
            "flash_attention_bwd": (
                torch.cat([t.flatten() for t in att.flash_attention_bwd(
                    q, k, v, o, lse, do, causal=True)]),
                torch.cat([t.flatten() for t in att.flash_attention_bwd_reference(
                    q, k, v, o, lse, do, causal=True)])),
            "window_attention": (att.window_attention(w, w, w, 64, scale=72 ** -0.5),
                                 att.window_reference(w, w, w, 64, 72 ** -0.5)),
            "gemm": (fb.gemm(x, wt, bias), fb.gemm_reference(x, wt, bias)),
            "layer_norm": (fb.layer_norm(x, g, beta, 1e-6),
                           fb.layer_norm_reference(x, g, beta, 1e-6)),
            "window_pool2x2": (fb.window_pool2x2(pool_x, 8),
                               fb.window_pool2x2_reference(pool_x, 8)),
            "int4_matmul": (tq.int4_matmul(xi, q4, s4), tq.int4_matmul_reference(xi, q4, s4)),
        }
        torch.cuda.synchronize(dev)
        before = torch.cuda.current_device()
    for name, (out, ref) in calls.items():
        if out.device != dev:
            raise AssertionError(f"second card: {name} returned a tensor on {out.device}")
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / max(ref.float().abs().max().item(), 1e-30)
        log(f"second card: {name} on {dev}: max_abs_err {err:.3e}, / max|plain| {rel:.3e} "
            f"(tol {SECOND_CARD_TOL})")
        if not rel <= SECOND_CARD_TOL:
            raise AssertionError(f"second card: {name} disagrees with its plain version")
    if before != 0:
        raise AssertionError(f"second card: PyTorch's current device moved to {before}")


def device_breakdown(run, top: int = 20, host: bool = False, match: str = None,
                     found: dict = None) -> float:
    """Run `run()` under torch.profiler, print the device time by kernel
    name and the host wall time around it, and return the device busy ms
    (the tracer slows the host, so that wall time is not the call's). The
    device's events are summed straight from the trace's raw events (the
    profiler's own aggregation of a long run's events takes tens of
    seconds); `host=True` also traces the host and prints its ops by self
    CPU time (the profiler's aggregation). With `match`, the device ms and
    launches of the kernels whose name holds it go into `found[match]`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    activities = [ProfilerActivity.CPU] if host else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}  # name -> [device ms, launches]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            k = kernels.setdefault(e.name(), [0.0, 0])
            k[0] += e.duration_ns() / 1e6
            k[1] += 1
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    busy_ms = sum(ms for ms, _ in kernels.values())
    log(f"profile: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall (traced); "
        f"{len(kernels)} kernel names; top {top}:")
    for name, (ms, n) in ranked[:top]:
        log(f"  {ms:9.2f} ms {n:6d}x  {name[:100]}")
    if match is not None:
        hits = [v for name, v in kernels.items() if match in name.lower()]
        found[match] = (sum(ms for ms, _ in hits), sum(n for _, n in hits))
    if host:
        ops = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                     key=lambda e: -e.self_cpu_time_total)
        log(f"profile: host ops by self CPU time (traced, so inflated), top {top // 2}:")
        for e in ops[:top // 2]:
            log(f"  {e.self_cpu_time_total / 1e3:9.2f} ms {e.count:6d}x  {e.key[:100]}")
    log(f"profile: {time.perf_counter() - t0:.2f} s with the trace's aggregation")
    return busy_ms


def export_run(state, card_line: str) -> dict:
    """Phase 6b's end: its trained state exported into build/export/ and
    read back on the host, bit-equal to the merged f32 state. Returns the
    state dict read back."""
    import torch
    from rga3_tpu_torch.models.qwen25vl.loader import load_unigr_state_dict
    from rga3_tpu_torch.train import export

    out = os.path.join(HERE, "build", "export")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    log(f"export: free disk {shutil.disk_usage(out).free / 1e9:.1f} GB, available host RAM "
        f"{host_available() / 1e9:.1f} GB before the write")
    t0 = time.perf_counter()
    n = export.export_hf_safetensors(state, out)
    sec = time.perf_counter() - t0
    size = os.path.getsize(os.path.join(out, export.EXPORT_FILE))
    log(f"export: export_hf_safetensors {n} tensors, {size / 1e9:.3f} GB in {sec:.2f} s "
        f"({size / 1e9 / sec:.2f} GB/s); {card_line}")
    t0 = time.perf_counter()
    got = load_unigr_state_dict(out)
    sec = time.perf_counter() - t0
    want = export.merged_state_dict(state)
    differ = [k for k, v in want.items()
              if k not in got or not torch.equal(got[k].to(v.device), v.float())]
    log(f"export: read back by load_unigr_state_dict in {sec:.2f} s, {len(got)} tensors; "
        f"{len(differ)} differ from the merged f32 state; LoRA merged into "
        f"{sum(k.endswith(('q_proj.weight', 'v_proj.weight')) for k in want)} q/v weights")
    if differ or set(got) != set(want) or len(got) != n:
        raise AssertionError(f"export: the reloaded state differs: {differ[:5]}")
    return got


def host_available() -> int:
    """MemAvailable of /proc/meminfo, in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise AssertionError("no MemAvailable in /proc/meminfo")


def polygon_check(seed: int) -> None:
    """F6: `data/polygon.py` against this machine's OpenCV on 6,000 random
    polygons (2,000 canvases, 3 shapes each, filled and outlined)."""
    import numpy as np
    from rga3_tpu_torch.data import polygon

    try:
        import cv2
    except ImportError:
        log("polygons: no OpenCV on this machine")
        return
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    differ = {"fill_poly": 0, "polylines": 0}
    n = 0
    for _ in range(2000):
        h, w = int(rng.integers(1, 160)), int(rng.integers(1, 200))
        for _ in range(3):
            k = int(rng.integers(1, 30))
            pts = [(rng.uniform(-0.3, 1.3, (k, 2)) * [w, h]).astype(np.int32)]
            for name, ref in (("fill_poly", cv2.fillPoly),
                              ("polylines", lambda im, p, v: cv2.polylines(im, p, True, v, 1))):
                a, b = np.zeros((h, w), np.uint8), np.zeros((h, w), np.uint8)
                getattr(polygon, name)(a, pts, 1)
                ref(b, pts, 1)
                differ[name] += not np.array_equal(a, b)
            n += 1
    log(f"polygons: data/polygon.py against OpenCV {cv2.__version__} on {n} random polygons: "
        f"{differ} differ ({time.perf_counter() - t0:.2f} s)")


def handoff_phase(frames, card_line: str, read_path, exported: dict) -> dict:
    """Phase 6c (see the module docstring): phase 6b's export quantized by
    the CLI and served; the in-process reference built from `exported`, the
    export as 6b read it back (bit-equal to the state it wrote), which is
    emptied. Returns the served requests' paths."""
    import gc

    import numpy as np
    import torch
    from rga3_tpu_torch.data.processor import QwenVLProcessor
    from rga3_tpu_torch.evaluation.segmentor import UniGRChat, UniGRSegmentor
    from rga3_tpu_torch.models.unigr import build as unigr_build
    from rga3_tpu_torch.models.unigr.model import UniGR
    from rga3_tpu_torch.ops.attention import reset_launches
    from rga3_tpu_torch.ops.quant import quantize_for_serving
    from rga3_tpu_torch.serve.__main__ import build_service, parse_args
    from rga3_tpu_torch.serve.app import serve
    from rga3_tpu_torch.tools import quantize_checkpoint as qc
    from rga3_tpu_torch.utils import rle

    src = os.path.join(HERE, "build", "export")
    q4 = os.path.join(HERE, "build", "export_q4")
    shutil.rmtree(q4, ignore_errors=True)
    paths = {}
    proc = QwenVLProcessor.from_pretrained("dummy")
    # the in-process reference: the export as read back in 6b, quantized on
    # the card, its float tensors in the served model's dtype
    t0 = time.perf_counter()
    ref32 = qc.model_for(exported, "unigr", "cuda")
    ref32.load_state_dict(exported, strict=True)
    exported.clear()
    quantize_for_serving(ref32.qwen, "int4")
    qcfg = ref32.cfg.qwen
    ref = UniGR(ref32.cfg.replace(
        qwen=qcfg.replace(text=qcfg.text.replace(quant_int4=True),
                          vision=qcfg.vision.replace(quant_int8=True)),
        seg=ref32.cfg.seg.replace(seg_token_id=proc.seg_token_id)),
        device="cuda", dtype=torch.bfloat16)
    ref.load_state_dict(ref32.state_dict(), strict=True)
    ref.eval()
    del ref32
    gc.collect()
    torch.cuda.empty_cache()
    log(f"handoff: in-process reference (6b's read-back of the export, quantize_for_serving "
        f"int4, {ref.dtype} floats) in {time.perf_counter() - t0:.2f} s")
    # the quantize CLI on the card
    t0 = time.perf_counter()
    qc.main(["--model_dir", src, "--out", q4, "--bits", "4"])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(q4, f)) for f in os.listdir(q4))
    log(f"handoff: quantize_checkpoint --bits 4 on the card {size / 1e9:.3f} GB in {sec:.2f} s; "
        f"{card_line}")
    gc.collect()
    torch.cuda.empty_cache()

    # the server's service from the quantized directory
    real = unigr_build._processor_dir
    unigr_build._processor_dir = lambda args, prequantized: "dummy"
    try:
        t0 = time.perf_counter()
        service = build_service(parse_args(["--model_dir", q4, "--model_size", TRAIN_CLI_MODEL,
                                            "--max_new_tokens", str(SERVE_TOKENS)]),
                                load_video=npy_video_loader)
        torch.cuda.synchronize()
    finally:
        unigr_build._processor_dir = real
    served = service.segmentor.model
    log(f"handoff: build_service --model_dir {os.path.relpath(q4, HERE)} in "
        f"{time.perf_counter() - t0:.2f} s; memory_allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    sd, want = served.state_dict(), ref.state_dict()
    differ = [k for k in want if k not in sd or sd[k].dtype != want[k].dtype
              or not torch.equal(sd[k], want[k])]
    log(f"handoff: the served model's {len(want)} tensors against the in-process model's: "
        f"{len(differ)} differ")
    if differ or set(sd) != set(want):
        raise AssertionError(f"handoff: the served model differs: {differ[:5]}")
    del sd, want  # the export stays for phase 6e, which deletes it

    upload = {"video": ("frames.npy", npy_bytes(np.stack(frames)))}
    qa_frames = sample_frames(frames, service.max_qa_frames)[0]
    question, expression = "What is happening in this video?", "the person on the left"
    per_forward = 7 * served.cfg.qwen.text.num_hidden_layers + 1
    httpd = serve(service, port=0, background=True, host="127.0.0.1")
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        reset_launches()
        t0 = time.perf_counter()
        answer = post_multipart(url + "/api/qa", {"question": question}, upload)["answer"]
        wall = time.perf_counter() - t0
        paths["handoff_qa"] = read_path()
        launched = paths["handoff_qa"][0]
        forwards = service.chat.last_stats["forwards"]
        t0 = time.perf_counter()
        direct = UniGRChat(ref, proc, max_new_tokens=SERVE_TOKENS).answer(
            question, video_frames=qa_frames)
        log(f"handoff qa: HTTP {wall:.3f} s (cold), in-process {time.perf_counter() - t0:.3f} s; "
            f"answer of {len(answer.split())} words, equal {answer == direct}; int4_matmul "
            f"{launched['int4_matmul']} = {per_forward} x {forwards} forwards; launches "
            f"{ {k: n for k, n in launched.items() if n} }; {card_line}")
        if answer != direct:
            raise AssertionError("handoff qa: the served answer is not the in-process one")
        if (launched["int4_matmul"] != per_forward * forwards
                or launched["flash_attention"] <= 0):
            raise AssertionError(f"handoff qa: int4_matmul {launched['int4_matmul']} for "
                                 f"{forwards} forwards, flash {launched['flash_attention']}")

        reset_launches()
        t0 = time.perf_counter()
        out = post_multipart(url + "/api/segment", {"expression": expression}, upload)
        wall = time.perf_counter() - t0
        paths["handoff_segment"] = read_path()
        launched = paths["handoff_segment"][0]
        t0 = time.perf_counter()
        masks = UniGRSegmentor(ref, proc, num_frames_mllm=8).segment_video(frames, expression)
        got = np.stack([rle.decode(m) for m in out["masks"]]).astype(bool)
        same = got.shape == masks.shape and np.array_equal(got, masks)
        log(f"handoff segment: HTTP {wall:.3f} s (cold), in-process "
            f"{time.perf_counter() - t0:.3f} s; {out['num_frames']} frames, foreground "
            f"{got.mean():.4f}, RLEs equal {same}; launches "
            f"{ {k: n for k, n in launched.items() if n} }; {card_line}")
        if not same:
            raise AssertionError("handoff segment: the RLE masks differ from segment_video's")
        # one teacher-forced forward, without the head (the [SEG] gather
        # reads the hidden states)
        if launched["int4_matmul"] != per_forward - 1:
            raise AssertionError(f"handoff segment: int4_matmul {launched['int4_matmul']}, "
                                 f"expected one headless forward's {per_forward - 1}")
        for k, n in HIERA_L_LAUNCHES.items():
            if launched[k] != n:
                raise AssertionError(f"handoff segment: {k}: {launched[k]} launches, "
                                     f"Hiera-L's blocks make {n}")
        missing = [k for k in SEGMENT_KERNELS if launched[k] <= 0]
        if missing:
            raise AssertionError(f"handoff segment: {missing} not launched")
    finally:
        httpd.shutdown()
        httpd.server_close()
    log(f"handoff: max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{card_line}")
    del service, served, ref
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(q4)
    return paths


# --------------------------------------------------------------------------


def verify_phase(card_line: str, read_path) -> dict:
    """Phase 6e: `python -m rga3_tpu_torch.tools.verify_checkpoints` in
    real mode on phase 6b's export (build/export: Qwen2.5-VL-7B + Hiera-L,
    f32 on disk, read in bf16), `--samples 1 --skip_act_diff` (the card has
    no transformers: act_diff is held on the CPU by the tests). Every stage
    must pass, config 9 (the learned tiny checkpoint, whose 2x2 Hiera
    windows take the window kernel's packed small windows) with its gIoU
    above 0.5. The counts are reset before the run and read after it; the
    export is deleted at the end. Returns the run's path."""
    import gc

    import torch
    from rga3_tpu_torch.ops.attention import reset_launches
    from rga3_tpu_torch.tools import verify_checkpoints as vc

    src = os.path.join(HERE, "build", "export")
    out = os.path.join(HERE, "build", "verify_checkpoints.json")
    log("verify: act_diff skipped (--skip_act_diff): the card has no transformers; the CPU "
        "tests hold it (tests/test_torch_verify_checkpoints.py)")
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        rc = vc.main(["--unigr_dir", src, "--samples", "1", "--skip_act_diff", "--out", out,
                      "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        path = read_path()
    finally:
        shutil.rmtree(src, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    with open(out) as f:
        report = json.load(f)
    stages = {"load": report["load"], **report["configs"]}
    for name, r in stages.items():
        extra = {k: v for k, v in r.items() if k not in ("ok", "seconds", "trace")}
        log(f"verify {name}: ok {r['ok']}, {r['seconds']} s; {extra}")
    learned = report["configs"].get("config9_learned", {})
    launched = path[0]
    small = sorted({key[4] for key in path[1]["window_attention"] if key[4] < 16})
    log(f"verify: verify_checkpoints {wall:.2f} s, exit code {rc}, all_ok {report['all_ok']}; "
        f"config 9 (learned tiny, {learned.get('dtype')}) gIoU {learned.get('gIoU')} cIoU "
        f"{learned.get('cIoU')} over {learned.get('n')} images; window attention at windows "
        f"under 16 tokens {small}; launches {({k: n for k, n in launched.items() if n})}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{card_line}")
    if rc != 0 or not report["all_ok"] or not all(r["ok"] for r in stages.values()):
        raise AssertionError(f"verify: a stage failed: "
                             f"{[n for n, r in stages.items() if not r['ok']]}")
    if report["load"].get("size") != TRAIN_CLI_MODEL or "skipped" in learned:
        raise AssertionError(f"verify: not the {TRAIN_CLI_MODEL} export, or config 9 skipped")
    missing = [k for k in SEGMENT_KERNELS + ("int4_matmul",) if launched[k] <= 0]
    if missing or not small:
        raise AssertionError(f"verify: {missing} not launched, or no window under 16 tokens")
    return {"verify_checkpoints": path}


def kernels_phase(paths: dict, seed: int) -> list:
    """Phase 7: each kernel against its plain version at every call the
    `paths` made (shapes, strides, masks and segment ids as recorded); a
    call's times count once for each launch of it in each path's run.
    Returns the kernels' JSON rows."""
    import torch

    gen = torch.Generator("cuda").manual_seed(seed)
    kernels = []
    for kname, check, src, replaces in KERNELS:
        tot = dict(ms=0.0, plain_ms=0.0, lib_ms=0.0, bound_ms=0.0, ops_ms=0.0, err=0.0,
                   core_ms=None)
        merged, per_path = {}, {}
        for pname, (_, pcalls) in paths.items():
            for key, (n, extra) in pcalls[kname].items():
                merged.setdefault(key, [0, extra, {}])
                merged[key][0] += n
                merged[key][2][pname] = n
        for key, (n, extra, by_path) in merged.items():
            r = check(key, extra, gen, REPS)
            log(f"kernel {kname} [{r['desc']}]: launches/call {n}, "
                f"max_abs_err {r['err']:.3e}, row err / max|ref| {r['rel']:.3e} "
                f"(tol {r.get('tol', ROW_TOL)}), ms {r['ms']:.4f}, bound_ms {r['bound'][0]:.4f} "
                f"({r['bound'][1]}), share of bound {r['bound'][0] / r['ms']:.3f}"
                + (" (above 1: L2-resident, the same inputs timed again and again)"
                   if r["bound"][1] == "bytes" and r["bound"][0] > r["ms"] else "") + ", "
                f"plain_ms {r['plain_ms']:.4f}, library_ms {r['lib_ms']}"
                + (f", TFLOP/s {r['flops'] / r['ms'] / 1e9:.1f} (library "
                   f"{r['flops'] / r['lib_ms'] / 1e9:.1f})" if "flops" in r else "")
                + (f", CUDA-core f32 bound_ms {r['cuda_core_bound'][0]:.4f} "
                   f"({r['cuda_core_bound'][1]}), share {r['cuda_core_bound'][0] / r['ms']:.3f}"
                   if "cuda_core_bound" in r else ""))
            for pname, pn in by_path.items():
                per_path[pname] = per_path.get(pname, 0.0) + pn * r["ms"]
            tot["ms"] += n * r["ms"]
            tot["plain_ms"] += n * r["plain_ms"]
            tot["lib_ms"] = (None if tot["lib_ms"] is None or r["lib_ms"] is None
                             else tot["lib_ms"] + n * r["lib_ms"])
            tot["bound_ms"] += n * r["bound"][0]
            if "cuda_core_bound" in r:
                tot["core_ms"] = (tot["core_ms"] or 0.0) + n * r["cuda_core_bound"][0]
            if r["bound"][1] == "operations":
                tot["ops_ms"] += n * r["bound"][0]
            tot["err"] = max(tot["err"], r["err"])
        total = sum(pl[kname] for pl, _ in paths.values())
        log(f"kernel {kname}: {total} launches, ms by path: "
            + ", ".join(f"{p} {paths[p][0][kname]}x {v:.4f}" for p, v in per_path.items())
            + ("" if tot["core_ms"] is None else
               f"; bound_ms {tot['bound_ms']:.4f} (3xTF32), CUDA-core f32 bound_ms "
               f"{tot['core_ms']:.4f}"))
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": total, "max_abs_err": tot["err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if tot["ops_ms"] * 2 >= tot["bound_ms"] else "bytes",
            "library_ms": tot["lib_ms"],
        })
    return kernels


def hash_seed_env(seed: int, environ) -> dict | None:
    """The environment to run this script again in, or None if it already
    runs in it: Python's str hash, salted per process unless PYTHONHASHSEED
    is set, maps the words of the prompts to token ids (the processor's
    word tokenizer), so that without it each run prompts the model with
    other ids and its outputs are not reproducible from the seed."""
    if environ.get("PYTHONHASHSEED") == str(seed):
        return None
    return {**environ, "PYTHONHASHSEED": str(seed)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    env = hash_seed_env(args.seed, os.environ)
    if env is not None:
        sys.stdout.flush()
        os.execve(sys.executable, [sys.executable, os.path.abspath(__file__), *sys.argv[1:]],
                  env)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import rga3_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the rga3_tpu_torch package is not beside this script: {e}",
              file=sys.stderr)
        return 2
    import numpy as np
    from rga3_tpu_torch.config import SegHeadConfig
    from rga3_tpu_torch.data.processor import QwenVLProcessor
    from rga3_tpu_torch.evaluation.segmentor import UniGRSegmentor
    from rga3_tpu_torch.models.qwen25vl import QWEN25_VL_7B
    from rga3_tpu_torch.models.sam2.config import Sam2Config, unfused
    from rga3_tpu_torch.models.sam2.model import Sam2Model
    from rga3_tpu_torch.models.unigr import UniGR, UniGRConfig
    from rga3_tpu_torch.ops import _kernels
    from rga3_tpu_torch.ops.attention import reset_launches, set_plain_attention

    t_all = time.perf_counter()
    # ---- 1. device
    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card_line = smi[0] if smi else "nvidia-smi: no output"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {kind} x{torch.cuda.device_count()}; nvidia-smi: {card_line}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    log(f"phase device: {time.perf_counter() - t0:.2f} s")

    # ---- 2. build
    t0 = time.perf_counter()
    _kernels.library()
    log(f"build: nvcc {_kernels.build_seconds if _kernels.build_seconds is not None else 0.0:.2f} s")
    entry = ""
    checked = {name: 0 for name in NO_SPILL}  # entries of each name with a spill line
    for line in _kernels.build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line or "spill" in line.lower():
            log(f"  ptxas: {entry}: {line.strip()}")
            # the tensor-core kernels (the attention forwards and backward,
            # the GEMM) keep every fragment and accumulator in registers: a
            # spill there is a design fault, not a slow kernel
            spills = re.search(r"(\d+) bytes spill stores", line)
            names = [name for name in NO_SPILL if name in entry]
            if names and spills:
                if int(spills.group(1)):
                    raise AssertionError(f"ptxas spills in {entry}: {line.strip()}")
                for name in names:
                    checked[name] += 1
    # a check that saw no ptxas line for a kernel has checked nothing
    unchecked = [name for name, n in checked.items() if not n]
    if unchecked:
        raise AssertionError(f"no ptxas spill line for {unchecked} in the build log "
                             f"({len(_kernels.build_log)} characters)")
    log(f"  ptxas: no spill in {checked}")
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        second_card_check(args.seed)
    else:
        log(f"cards: torch.cuda.device_count() = {n_cards}: a launch on a second card "
            "(cuda:1) was not exercised")
    log(f"phase build: {time.perf_counter() - t0:.2f} s")

    # ---- 3. main path at full width
    t0 = time.perf_counter()
    seed = args.seed
    rng = np.random.default_rng(seed)
    n_frames, fh, fw = 8, 480, 854
    frames = [rng.integers(0, 256, (fh, fw, 3), dtype=np.uint8) for _ in range(n_frames)]
    expressions = ["the person on the left", "the red car moving away"]
    proc = QwenVLProcessor.from_pretrained("dummy")
    # the release LoRA (r=128, alpha=256 on q_proj / v_proj); B starts at
    # zero, so the adapters change no output until the training phase
    qwen = QWEN25_VL_7B.replace(text=QWEN25_VL_7B.text.replace(lora_rank=128, lora_alpha=256.0))
    cfg = UniGRConfig(
        qwen=qwen, sam2=Sam2Config(),
        seg=SegHeadConfig(out_dim=256, seg_token_id=proc.seg_token_id),
    )
    chunk = 8
    model = UniGR(cfg, device="cuda", dtype=torch.bfloat16)
    model.init_weights(torch.Generator("cuda").manual_seed(seed))
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"model: UniGR Qwen2.5-VL-7B + SAM2 Hiera-L (Sam2Config()), {n_params / 1e9:.3f} B "
        f"params in bf16, built on the card in {time.perf_counter() - t0:.2f} s")
    seg = UniGRSegmentor(model, proc, num_frames_mllm=8, sam_chunk=chunk)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t1 = time.perf_counter()
    masks = seg.segment_video_multi(frames, expressions)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    wrappers = kernel_wrappers()
    read_path = launch_snapshot
    launches, calls = read_path()
    paths = {"segment_video_multi": (launches, calls)}
    log(f"main path: segment_video_multi {wall:.3f} s; phases (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in seg.phase_seconds.items()))
    log(f"main path: masks {masks.shape} {masks.dtype}, foreground {masks.mean():.4f}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"main path launches: {launches}; distinct calls: "
        + ", ".join(f"{k} {len(v)}" for k, v in calls.items()))
    if masks.shape != (len(expressions), n_frames, fh, fw):
        raise AssertionError(f"mask shape {masks.shape}")
    for k in SEGMENT_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched on the main path")
    for k, n in HIERA_L_LAUNCHES.items():
        if launches[k] != n:
            raise AssertionError(f"{k}: {launches[k]} launches, Hiera-L's blocks make {n}")
    # the same call again, warm (kernels loaded, allocator and cuBLAS set up)
    for k in seg.phase_seconds:
        seg.phase_seconds[k] = 0.0
    t1 = time.perf_counter()
    seg.segment_video_multi(frames, expressions)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t1
    log(f"main path, warm call: segment_video_multi {warm:.3f} s; "
        "phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in seg.phase_seconds.items()))
    # where the device time goes: one more call, traced
    busy = device_breakdown(lambda: seg.segment_video_multi(frames, expressions), host=True)
    log(f"profile: device busy in the traced call / wall of the untraced warm call "
        f"of this run: {busy:.1f} / {warm * 1e3:.1f} ms = {busy / (warm * 1e3):.3f}")
    log(f"phase main_path: {time.perf_counter() - t0:.2f} s")

    # ---- 3b. the benchmark drivers through their CLIs, on a model of their own
    t0 = time.perf_counter()
    paths.update(eval_phase(seed, card_line, read_path))
    log(f"phase eval: {time.perf_counter() - t0:.2f} s")

    # ---- 4. chat: KV-cached decode in float and in int4 serving, same video
    t0 = time.perf_counter()
    chat_paths, chat4 = chat_phase(model, proc, frames, read_path)
    paths.update(chat_paths)
    log(f"phase chat: {time.perf_counter() - t0:.2f} s")

    # ---- 4b. STOM region QA: overlay propagation + int4 answer_batch
    t0 = time.perf_counter()
    stom_paths, tracker = stom_phase(chat4, frames, seed, card_line, read_path)
    paths.update(stom_paths)
    log(f"phase stom: {time.perf_counter() - t0:.2f} s")

    # ---- 4d. the region-QA drivers through their CLIs, on the int4 chat
    t0 = time.perf_counter()
    paths.update(region_qa_phase(chat4, tracker, frames, seed, card_line, read_path))
    del chat4, tracker
    torch.cuda.empty_cache()
    log(f"phase region_qa: {time.perf_counter() - t0:.2f} s")

    # ---- 4e. STOM's tracker trained through its CLI (no kernel of the port)
    t0 = time.perf_counter()
    stom_train_phase(frames, card_line, read_path)
    log(f"phase stom_train: {time.perf_counter() - t0:.2f} s")

    # ---- 4c. the demo server: int4 UniGR + 3B draft, driven over HTTP
    t0 = time.perf_counter()
    paths.update(serve_phase(frames, seed, card_line, read_path))
    log(f"phase serve: {time.perf_counter() - t0:.2f} s")

    # ---- 5. the plain route, called explicitly, on the same weights
    t0 = time.perf_counter()
    emb_k, has_k = seg._seg_embedding(frames, expressions[0])
    logits_k = seg.decode_logits(seg.encode_frames(frames[:chunk]), emb_k)
    set_plain_attention(model, True)
    emb_p, has_p = seg._seg_embedding(frames, expressions[0])
    logits_p = seg.decode_logits(seg.encode_frames(frames[:chunk]), emb_k)
    set_plain_attention(model, False)
    for name, t in (("[SEG] kernel", emb_k), ("[SEG] plain", emb_p),
                    ("mask logits kernel", logits_k), ("mask logits plain", logits_p)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{name}: non-finite values")
    emb_rel = ((emb_k.float() - emb_p.float()).norm() / emb_p.float().norm()).item()
    agree = ((logits_k > 0) == (logits_p > 0)).float().mean().item()
    logit_rel = ((logits_k - logits_p).abs().max() / logits_p.abs().max()).item()
    log(f"plain route: has_seg {has_k}/{has_p}; [SEG] embeddings and mask logits "
        f"{tuple(logits_k.shape)} finite; [SEG] embedding rel err {emb_rel:.3e}; "
        f"mask logits max err / max|logit| "
        f"{logit_rel:.3e}, mask agreement {agree:.5f}")
    if not (has_k and has_p and emb_rel < 0.1 and agree > 0.95):
        raise AssertionError("the kernel route disagrees with the plain route")
    # the earlier (unfused) Hiera path on the same weights and [SEG] embedding
    fused_sam = model.grounding_encoder
    unfused_sam = Sam2Model(unfused(cfg.sam2), device="cuda", dtype=torch.bfloat16)
    unfused_sam.load_state_dict(fused_sam.state_dict())
    unfused_sam.eval()
    model.grounding_encoder = unfused_sam
    reset_launches()
    logits_u = seg.decode_logits(seg.encode_frames(frames[:chunk]), emb_k)
    torch.cuda.synchronize()
    unfused_launches = {k: f.launches for k, f in wrappers.items() if f.launches}

    def encode_s(sam):
        model.grounding_encoder = sam
        t = time.perf_counter()
        seg.encode_frames(frames[:chunk])
        torch.cuda.synchronize()
        return time.perf_counter() - t

    # SAM encode of one 8-frame chunk, both routes warm, in turns (pairs
    # alternate which route runs first); host time varies by ~10% call to
    # call, so a pair alone does not order the routes
    turns = [("fused", fused_sam), ("unfused", unfused_sam)]
    times = {"fused": [], "unfused": []}
    for i in range(ENCODE_PAIRS):
        for name, sam in (turns if i % 2 == 0 else turns[::-1]):
            times[name].append(encode_s(sam))
    log(f"SAM encode of one chunk, warm, {ENCODE_PAIRS} pairs in turns (s): " + "; ".join(
        f"{name} median {statistics.median(t):.4f} [" + " ".join(f"{x:.4f}" for x in t) + "]"
        for name, t in times.items()))
    model.grounding_encoder = fused_sam
    del unfused_sam
    agree_u = ((logits_k > 0) == (logits_u > 0)).float().mean().item()
    logit_rel_u = ((logits_k - logits_u).abs().max() / logits_u.abs().max()).item()
    log(f"unfused Hiera path, same weights and [SEG] embedding: "
        f"launches {unfused_launches}; mask logits max err / max|logit| "
        f"{logit_rel_u:.3e}, mask agreement with the fused route {agree_u:.5f}")
    if not (torch.isfinite(logits_u).all() and agree_u > 0.95
            and unfused_launches.get("window_attention", 0) > 0
            and not any(k.startswith("fused_") for k in unfused_launches)):
        raise AssertionError("the unfused Hiera path disagrees with the fused route")
    del seg, emb_k, emb_p, logits_k, logits_p, logits_u
    torch.cuda.empty_cache()
    log(f"phase plain_route: {time.perf_counter() - t0:.2f} s")

    # ---- 5b. the SAM2 memory tracker on the same weights and frames
    t0 = time.perf_counter()
    paths.update(tracker_phase(model, proc, frames, expressions, read_path))
    log(f"phase tracker: {time.perf_counter() - t0:.2f} s")

    # ---- 5c. the legacy UniGR (SAM-v1 ViT-H) on phase 3's Qwen2.5-VL
    t0 = time.perf_counter()
    paths.update(legacy_phase(model, proc, frames, expressions, seed, card_line, read_path))
    log(f"phase legacy: {time.perf_counter() - t0:.2f} s")

    # ---- 5d. the main path's switches, each against its default route
    t0 = time.perf_counter()
    paths.update(switches_phase(model, proc, frames, expressions, masks, card_line, read_path))
    log(f"phase switches: {time.perf_counter() - t0:.2f} s")

    # ---- 6. train: the UniGR train step at the same width, on these weights
    t0 = time.perf_counter()
    paths.update(train_phase(model, frames, seed, read_path))
    del model
    torch.cuda.empty_cache()
    log(f"phase train: {time.perf_counter() - t0:.2f} s")

    # ---- 6b. the training entry point at the release config, with a resume,
    # under a process group of one rank (NCCL)
    t0 = time.perf_counter()
    cli_paths, exported = train_cli_phase(seed, card_line, read_path)
    paths.update(cli_paths)
    log(f"phase train_cli: {time.perf_counter() - t0:.2f} s")

    # ---- 6c. hand-off: the polygons against OpenCV, then 6b's export
    # quantized by the CLI and served
    t0 = time.perf_counter()
    polygon_check(seed)
    paths.update(handoff_phase(frames, card_line, read_path, exported))
    del exported
    log(f"phase handoff: {time.perf_counter() - t0:.2f} s")

    # ---- 6d. the tensor axis: two ranks (processes) on this card over gloo
    # against this process alone, generation in bf16 and int4 and training
    t0 = time.perf_counter()
    paths.update(tensor_phase(seed, frames))
    log(f"phase tensor: {time.perf_counter() - t0:.2f} s")

    # ---- 6e. checkpoint verification in real mode on 6b's export (7B +
    # Hiera-L), configs 1-9 on the card
    t0 = time.perf_counter()
    paths.update(verify_phase(card_line, read_path))
    log(f"phase verify: {time.perf_counter() - t0:.2f} s")

    # ---- 7. each kernel against its plain version, at every call the paths
    # made
    t0 = time.perf_counter()
    kernels = kernels_phase(paths, seed)
    torch.cuda.empty_cache()
    log(f"phase kernels: {time.perf_counter() - t0:.2f} s")

    # ---- 8. small models on the card against the same models on the CPU
    t0 = time.perf_counter()
    small_reference(seed)
    small_legacy_reference(seed)
    small_chat_reference(seed)
    log(f"phase reference: {time.perf_counter() - t0:.2f} s")

    log(f"total: {time.perf_counter() - t_all:.2f} s")
    log("kernel launches/ms/plain_ms/bound_ms/library_ms: over one run of each path ("
        + ", ".join(paths) + "), the per-call times above times their launches")
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
