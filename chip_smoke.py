#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA card
    python3 chip_smoke.py --quick    # build + kernels vs plain only
    python3 chip_smoke.py --phase-m  # phase M alone (no build, no result)
    python3 chip_smoke.py --phase-t  # phase T alone (no build, no result)
    python3 chip_smoke.py --phase-u  # phases U and E alone (no result)
    python3 chip_smoke.py --phase-d  # phase D alone (no result)
    python3 chip_smoke.py --phase-c  # phase C's column deals (no result)
    python3 chip_smoke.py --phase-q  # phase Q and the mesh check (no result)
    python3 chip_smoke.py --phase-k  # phase K alone (no result)
    python3 chip_smoke.py --phase-r  # phase R alone (no build, no result)

Phases, each printing one line (or a few):

1. the card's name and power limit (nvidia-smi), then the build of the
   seven kernels (biosignal graph, ASR graph, FIR, FFT, shuffle, RoPE,
   flash attention) and of `rope.cu` with one slot's table applied to
   the slot before it (`ROPE_WRONG_SLOT`), one nvcc each, all started
   together, and the TF32
   HGMMA instructions of each float32 flash-attention instantiation
   (cuobjdump -sass; the run fails where one has none);
2. the fused biosignal graph kernel held against its plain PyTorch
   version on the card, for the framed, stream and ring entries, at the
   full width (window 2048, hop 512) and every output selection; stream,
   framed and ring slot r must agree bitwise; and what the check would
   read from the plain stage bodies with the FFT's second pass conjugated
   or each median taken one rank high (`wrong_biosignal_readings`; the
   run fails unless `TOL` flags both);
A1. the three kernels of the ASR slice against their plain versions: the
   ASR graph at every entry and output selection (window 512, hop 160;
   stream == framed == ring slot bitwise) and what the check would read
   from the plain stage bodies with the FFT's second pass conjugated or
   each mel span one bin short (`wrong_asr_readings`; the run fails
   unless `ASR_LOGMEL_TOL` flags both), the FIR in all seven row dtypes
   (`FIR_DTYPES`, integers at full scale) at 2, 11, 65, 255 and 2048
   taps on rows longer than one tile, bitwise the plain version, the FFT
   at N 2 to 8192 (`FFT_CASES`, one launch) and every power of 2 from
   16384 to 2^20 (`FOUR_STEP_CASES`, the four-step transform's two
   launches, counted),
   forward and inverse, float32, bfloat16 and float16, each also measured
   as a transform with its first stage's twiddles conjugated would read
   (`wrong_fft_reading`) and, past 8192, as the four-step without its
   inter-pass twiddle would (`wrong_four_step_reading`; the run fails
   unless `FFT_TOL` flags both), and one float32 row of 2^24 points both
   ways (`FFT_BIG`: the plain version's 1.6 GB table fits);
A3. the shuffle, RoPE and flash-attention kernels against their plain
   versions at edge shapes: every shuffle op and half at N 2/64/128/256
   and shifts 0/32/-5/2N+3 (bitwise); both RoPE layouts at dh
   18/32/120/128, 1 to 16 heads a slot, aligned and offset bases (the
   kernel's 16-byte, 8-byte and scalar paths) and positions up to 8192;
   attention with GQA, windows, Sq != Skv
   without causal, S not a multiple of the kernel's tile, dh 20 (rows of
   40 bytes) to 256, one query over 777 keys, a 64-key window over 4,096
   keys, 32 heads at S 65, dh 144, 184 and 200, dh 18 and 25 (4- and
   2-byte copies), q and k scaled so that scores reach about +-30, and
   128 queries over 32,768 keys without a mask;
3. the biosignal main path: `BiosignalStream(...).process` over a
   24-hour, 64 Hz synthetic recording (5,529,600 samples, 10,797 frames)
   for batch_windows 8 and 512, with and without the filtered output,
   plus the host-framed reference; the kernel's launch count must rise as
   expected, and every row of every run is held against the plain version;
4. `ResidentStream.process` on the same signal, bitwise equal to phase 3,
   with drained totals equal to the frame count;
C. the column paths on the same day, each bitwise equal to phase 3's
   single-column output and each with its launch count checked:
   `pipeline_stream_sharded` and `pipeline_sharded` over 4 columns (one
   launch a column), `BiosignalStream` with ``n_columns=4`` at
   batch_windows 8 kernel-framed, host-framed and with
   ``column_weights=(1, 1, 2, 4)`` (one launch per column a dispatch),
   all of these again with the column mesh ``(cuda:0,) * 4`` (each
   column on a CUDA stream of its own; bitwise, the same launches) and,
   where `column_mesh(4)` gives four cards (it must be None on fewer),
   on those cards, printing the host ms a dispatch of the serial columns
   and of each mesh in one line, the two entries' warm medians (five
   synchronised calls after the first) in another, and, over four cards,
   whether every pair has peer access and what one column's outputs take
   to copy back to card 0 alone;
   and `FaultTolerantColumnRunner(n_columns=4)` in batch mode fault-free,
   with column 1 killed at its 170th dispatch (the run fails unless it
   requeued) and with two transient faults on column 2, and in resident
   mode (ring_depth 4) with column 3 killed at drain 1; prints each
   runner's per-column `column_busy` and the kill run's
   max(column_busy) over the fault-free run's beside the reference's
   1.5x bound (host time: printed, not gated);
A2. the ASR main path over one hour of 16 kHz audio (57,600,000 samples,
   359,997 frames of window 512, hop 160): the host-driven stream at
   batch_windows 32 and 512, the host-framed reference, `ResidentStream`
   at ring_depth 4, one `graph_pipeline_stream` call over the hour, all
   bitwise equal, every row held against the plain version; then
   `asr_staged` (the FIR and FFT kernels) over the same hour, held to the
   fused path, `pipeline_staged` over the biosignal day (class agreement
   1.0; the smallest |margin| printed), and the FFT at `asr_staged`'s
   shape (359,997 x 256) in float32 and bfloat16 against its plain
   version and against what a conjugated first stage would read;
S. the standalone entries at their users' full widths, each run with the
   launch counts set to 0 just before and read just after, every output
   against the plain version: `shuffle` (S1: every op on the hour's ASR
   frames split into A and B, 359,997 x 256 float32, and three ops on
   each half; S2: every op on a million VWRs of 128 int32 words, bitwise),
   `rope` (R1: a qwen1.5-0.5b prefill's q, (4, 2048, 16, 64), theta 1e6,
   both layouts in float32 and bfloat16; R2: an h2o-danube3-4b q, (1,
   8192, 32, 120), theta 1e4, bfloat16; one int32 position per slot; at
   R1 also what the check would read from `rope_wrong_slot`, and the run
   fails unless `ROPE_TOL` flags it) and
   `flash_attention` (F1: qwen1.5-0.5b prefill, B 4, S 2048, 16 heads, dh
   64, causal; F2: h2o-danube3-4b, S 8192, 32 heads over 8 kv heads, dh
   120, causal, window 4096; F3: whisper-medium's encoder, B 8, S 1500, 16
   heads, dh 64, no mask, chunks 300; each in bfloat16 and float32), the
   plain attention computed one kv-head group at a time, and what the
   check would read from a kernel that drops one 64-key tile of each
   row's band and, in float32, from one that runs one TF32 product in
   place of each 3xTF32 triple (the run fails unless the tolerance flags
   both);
5. per-kernel times (CUDA events behind a device sleep) beside the bound
   worked out from the bytes and operations each call needs on this
   run's data (for attention over the live pairs of the mask, at the
   bfloat16 tensor-core peak for bfloat16; for float32 the least of the
   67 TFLOP/s CUDA cores and three TF32 products at 495 TFLOP/s, both
   printed),
   the plain version's time and, for the FIR, the FFT, attention and
   every shuffle op but bit_reverse, one PyTorch call computing the same
   function (timed here only; the shuffle's held bitwise to the kernel's
   output); the FFT
   also in bfloat16 at the same shape; phase K's four-step FFT and
   255-tap FIR as two more entries of the result line; for
   attention also the rate over the 4 dh operations per live pair, the
   share of the bound and the ratio to that call;
6. the ported kernels and the entries that launched them;
L. LM serving at qwen1.5-0.5b's full width (24 layers, d_model 1024,
   vocab 151,936; float32 parameters from seed 0, bfloat16 compute),
   with the launch counts set to 0 before and read after (the path
   launches none of the port's kernels): L1 the parameter count and
   `max_memory_allocated` after each step; L2 four prompts of 64-300
   tokens prefilled, then 8 teacher-forced decode steps, each step's
   logits against `model.forward` over the extended sequences; L3 one
   64-token prompt and 4 decode steps on the card against the same
   parameters on the CPU, and what the check reads from a decode whose
   rope angle is one position late (the run fails unless `LM_TOL` flags
   it); L4 `Engine(slots=4, max_len=1024)` serving 8 requests of 16-480
   prompt tokens, max_new 32, greedy three times and at temperature 0.8
   twice (every request finishes, repeats are identical, each first
   step's logits agree with its prompt prefilled alone), and whether
   slots 1, slots 2 and a reversed submission order change any tokens
   (printed); L5 prefill per bucket, decode ms a step at slots 4 and 16
   (CUDA events, host wall, the card's busy time and launches of one
   call from a `torch.profiler` trace, the idle share) beside the bytes
   bound, and generated tokens/s end to end;
P. paged KV, the supervised engines and the unified front-end, each run
   with the launch counts set to 0 before and read after. P1
   `PagedEngine(slots=4, max_len=1024, page_size=16)` against the dense
   `Engine` on phase L's 8 requests, greedy and at temperature 0.8, and
   on the reference bench's oversubscribed mix (14 requests of 2 prompt
   tokens, max_new 12, max_len 256): every request finishes, every page
   is freed, ``peak_admitted`` is 14 on the mix, each request's decode
   logits up to its first greedy token that differs are within `LM_TOL`
   of dense, a repeated run and a run through a defrag after every
   finish are bitwise (every decode's logits); prints token
   agreement with dense and one decode step's times (as L5) beside
   dense's. P2 `FaultTolerantEngine` and `FaultTolerantPagedEngine` on
   the 8 requests at 0.8, fault-free (bitwise P1's unsupervised tokens),
   with slot 0 killed at its dispatch 4 (one eviction, one replay, every
   token retired before the kill bitwise) and with one transient
   (absorbed, bitwise); prints the agreement after the kill and the
   recovered / fault-free wall. P3 whisper-medium at full width (24 + 24
   layers, d_model 1024, vocab 51,865, enc_ctx 1500; random weights from
   seed 0): its logits on the card against the CPU (one 8-token prompt
   over 1,500 frames from a seed, prefill + 2 decodes, within
   `WHISPER_TOL`; the run fails unless the tolerance flags a decode with
   the encoder K/V zeroed), then `ServeFrontend` on a
   `FaultTolerantEngine(slots=4)` and a `ColumnScheduler` over 4 columns
   of the card: 4 LM requests, 2 `StreamOpen`s and 3 `AsrTranscribe`s of
   30 s of synthetic 16 kHz audio under QoS {lm: 2, stream: 1, asr: 1}:
   every ticket done, the dispatch order the policy's, one ASR graph
   launch a ticket (and none of any other kernel), features bitwise a
   direct `graph_pipeline_stream` call and within `ASR_LOGMEL_TOL` of the
   plain version; ``max_queue=1`` backpressure re-dispatches without a
   second launch; `lend_columns` (1, then 3: one stream re-pins) and
   `return_columns` restore the columns, the streams' outputs bitwise.
M. the other model families at full width and depth, random weights
   from seed 0 drawn and cast one leaf at a time (`init_cast_params`),
   each run with the launch counts set to 0 before and read after (no
   kernel may launch): deepseek-moe-16b (28 layers, 64 routed + 2
   shared experts, top-6), rwkv6-7b (32 layers, d_model 4096), zamba2-7b
   (81 Mamba2 layers, the shared attention block at 13 points) and
   qwen2-vl-2b (256 patch embeddings, distinct t/h/w position streams).
   For each: the load's time and peak memory; 4 prompts prefilled and 4
   teacher-forced decode steps against forward within `M_CACHE_TOL` (MoE
   at a capacity of E/k, which drops nothing, and at its own capacity
   the prefill against forward on the same tokens); the first 2-6
   layers of the same weights on the card against the host CPU within
   `M_TOL` (MoE with the CPU replaying the card's top-k choices; the
   share of choices that differ printed); what both checks read from a
   mis-computation (`family_wrong`: routing one rank down, a recurrent
   state read transposed, a decode at its sequence index instead of its
   M-RoPE position; the run fails unless the tolerance flags it); for
   rwkv and zamba2 a chunked prefill against 100 decode steps in
   float32 compute; then `Engine(slots=4, max_len=1024)` on phase L's 8
   requests greedy twice (identical) and at temperature 0.8, MoE also
   through `PagedEngine(page_size=16)` (pages freed, agreement with
   dense printed) and rwkv and zamba2 refused by it, typed; one decode
   step's host wall, busy time and launches beside its bytes bound, and
   generated tokens/s (qwen2-vl, which no engine serves: one timed
   decode).
T. training, each part run with the launch counts set to 0 before and
   read after (no kernel may launch). T1 qwen1.5-0.5b at full width and
   depth, float32 weights from seed 0, bfloat16 compute, `launch/
   train.py`'s defaults (batch 8 x 256 synthetic tokens, lr 3e-3, fp32 m
   and v): the first 2 layers' loss and gradient tree on the card
   against the host CPU within `TRAIN_TOL` (the run fails unless it
   flags the head's use of the tied embedding detached); one
   `adamw_update` on identical gradients, card against CPU, within
   `ADAM_TOL` (and flagging the bias correction dropped); two 6-step
   runs from seed 0 bitwise equal; 3 steps, an async checkpoint, the
   loop's resume from it and 3 more steps bitwise the uninterrupted run;
   the step's host wall, busy time, launches, idle share, tokens/s and
   peak memory beside its bound (printed, not gated). T2
   deepseek-moe-16b at its published width, 4 layers (the dense one and
   3 MoE), bfloat16 m and qint8 v: 2 layers card against CPU within
   `TRAIN_TOL` with the CPU replaying the card's routing, 3 steps on 2 x
   512 tokens (the aux loss positive and finite), m and v through a
   checkpoint bitwise, the peak memory beside the reckoned state.

U. autotuning on the card (`core/autotune.py`) at the main path's
   shapes, each search from an empty cache with the launch counts set to
   0 just before and read just after: the biosignal day as
   `BiosignalStream` at batch_windows 8 and 512, kernel- and
   host-framed, and as one `graph_pipeline_stream` call; the ASR hour at
   batch_windows 32 and in one call; `ResidentStream` on the day at B=8
   with ``ResidentConfig(autotune=True)`` (the ring depth); the FIR and
   the FFT at `pipeline_staged`'s shapes. For each key: the candidates'
   times (CUDA events; one clock a search, device time alone or host gaps
   in, the ring depth always the latter) with the spread of their reps,
   the default's, the winner and the search's host cost; every tuned
   output bitwise its untuned run, the launches the untuned run's plus
   the search's;
E. the paper's application end to end, `launch.biosignal_app.run` on
   the card (window 2048, hop 512, autotune on): its readings printed;
   stream against staged <= 1e-3 and the 4-column delta <= 1e-4 (the
   example's bounds), the SVM fit against the same fit on the CPU within
   `E_FIT_RTOL`, the holdout classes equal, the simulator's cycles and
   class equal to a run with the CPU's fit, and the biosignal graph
   kernel launched (stream and frames entries);
D. (run after phase A2) bfloat16 and float16 signals through both graph
   kernels: the day at B=8 kernel- and host-framed, resident, in one call
   and over 4 columns, the hour at B=32 and in one call, every output,
   each bitwise the float32 kernel on the widened signal (``filtered``
   rounded to the dtype) with its launches counted, the one call against
   the plain version over the whole signal (class exact, ``filtered``
   bitwise); int16, int32, int8 and uint8 signals near full scale
   (``filtered`` saturates) at the stream, frames and ring entries of
   both graphs, each bitwise the float32 kernel on the widened signal and
   against the plain version; an int64 signal of scale 3e9 at those
   entries, int32 ``filtered``, bitwise the int32 kernel on the signal
   narrowed to its low 32 bits; the int8 and uint8 day (B=8) and hour
   (B=32) through `BiosignalStream`, its host-framed path and
   `ResidentStream`, bitwise the float32 kernel on the widened signal;
   uint16 and float64 refused at the launchers; each entry's device time
   per dtype beside float32's and the dtype's bound;
K. (run after phase D) the FFT past 8192 points and the FIR past 64 taps
   through the user entries, each run with the launch counts set to 0
   before and read after: `fft` over a 2^20-point row (a 17-minute record
   at 1 kHz) in float32, bfloat16 and float16 both ways and `rfft` of
   the record, two launches each (the four-step's columns and rows),
   within `FFT_TOL` of the plain version; `fir` with 255 taps over the
   day's 10,797 x 2048 frames in all seven row dtypes, one launch each,
   bitwise the plain version; then each one's device time beside its
   bound, the plain version and `torch.fft.fft` or `conv1d` (the FFT also
   over 64 rows of 2^20 and one row each of 2^24, 2^14 and 2^17 points,
   the FIR also at 65 and 2048 taps in float32);
Q. `launch.quickstart.main` and `launch.asr_frontend.main` as a user runs
   them (their examples' checks), each with its launches counted (the
   FFT and FIR once in the quickstart; the ASR graph 16 times and the
   FIR and FFT once in the ASR entry); then the mesh check:
   qwen1.5-0.5b's parameters laid out on `make_local_mesh(1, 1)` over the
   card by the serve strategy, each local shard bitwise its parameter.
R. the multi-rank substrate on one card (NCCL, world 1), with the launch
   counts set to 0 before and read after (no kernel may launch): R1
   `make_serve_step` on `make_local_mesh(1, 1)`, qwen1.5-0.5b at full
   width and depth in bfloat16, one prefill of 4 x 64 tokens and 8 greedy
   decode steps bitwise `model.prefill` / `model.decode` (logits and
   every cache leaf), the greedy tokens and a decode step's host wall,
   busy time and launches; the run fails unless the check flags a decode
   that does not write its cache back; R2 `gpipe_apply` at one stage at
   `launch/dryrun_pp.py`'s widths in bfloat16 (8 x 256 tokens, 4
   microbatches) against the sequential loop, forward and gradient
   within `GPIPE_TOL`, failing unless it flags a lost hand-off; R3
   `psum_compressed` at world 1 bitwise the int8 round trip; R4
   `python -m repro_torch.launch.dryrun` on the T1 step (a 1 x 1 mesh,
   8 x 256; on the host) in a subprocess, its per-device FLOPs, bytes and
   roofline bound beside T1's busy time and `train_work`'s bound, and its
   peak memory beside the card's `max_memory_allocated` over one T1 step
   with one state held (run in R4): the ratio within `R_PEAK_RATIO`.

The last two lines are a JSON object of per-kernel numbers and the
contract line ``{"ok": true, "device": {...}}``. Any failing phase raises,
so the script exits non-zero and prints no result; it also does so when
no card is present or when the repository's `src/` is missing. Details
too long for the output go to ``chiprun_out/chip_smoke.json``.

Float32 matrix products and convolutions run without TF32
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set False). Imports torch and the
port only — never jax, never the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WINDOW, HOP, FFT = 2048, 512, 512
DAY_SAMPLES = 24 * 3600 * 64                  # 5,529,600
ASR_WINDOW, ASR_HOP, ASR_RATE = 512, 160, 16000
HOUR_SAMPLES = 3600 * ASR_RATE                # 57,600,000
HOUR_FRAMES = 359_997
PEAK_FP32 = 67e12                             # H100 SXM, non-tensor fp32
PEAK_BF16 = 989e12                            # H100 SXM, dense bf16 tensor
PEAK_TF32 = 495e12                            # H100 SXM, dense TF32 tensor
PEAK_BYTES = 3.35e12                          # H100 SXM HBM3
SOURCE = "src/repro_torch/kernels/pipeline/csrc/biosignal_graph.cu"
ASR_SOURCE = "src/repro_torch/kernels/pipeline/csrc/asr_graph.cu"
FIR_SOURCE = "src/repro_torch/kernels/fir/csrc/fir.cu"
FFT_SOURCE = "src/repro_torch/kernels/fft/csrc/fft.cu"
REPLACES = {"frames": "src/repro/kernels/pipeline/graph.py:479",
            "stream": "src/repro/kernels/pipeline/graph.py:526",
            "ring": "src/repro/kernels/pipeline/graph.py:575"}
ASR_STAGES = " (stage bodies src/repro/kernels/pipeline/asr.py:115/127/140)"
FIR_REPLACES = "src/repro/kernels/fir/kernel.py:56"
FFT_REPLACES = "src/repro/kernels/fft/kernel.py:86"
SHUFFLE_SOURCE = "src/repro_torch/kernels/shuffle/csrc/shuffle.cu"
ROPE_SOURCE = "src/repro_torch/kernels/rope/csrc/rope.cu"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/" \
    "flash_attention.cu"
SHUFFLE_REPLACES = "src/repro/kernels/shuffle/kernel.py:86"
ROPE_REPLACES = "src/repro/kernels/rope/kernel.py:55"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:102"
# |kernel - plain| <= ATOL + RTOL * |plain|, per output. The FIR and the
# SVM run in the same order in both, without FMA; the delineation mean,
# the FFT-segment mean and the band sums are reductions in another order.
TOL = {"filtered": (1e-6, 1e-6), "features": (1e-5, 1e-5),
       "margin": (1e-4, 1e-5)}
# ASR graph: filtered exact (the same FIR in the same order); logmel within
# `ASR_LOGMEL_TOL` of kernels/pipeline/asr.py (which says why) times the
# largest |plain| of the compared rows, at least 1. The plain stage bodies
# with the FFT's second pass conjugated, or with each mel span one bin
# short, must read above it: `wrong_asr_readings` measures both on every
# run and the run fails unless the tolerance flags them.
# standalone kernels: max |kernel - plain| <= tol * max |plain|; the FFT's
# tolerance is `FFT_TOL` of kernels/fft/kernel.py, which says why. A
# transform with its first stage's twiddles conjugated must read above it:
# `wrong_fft_reading` measures that on every run and the run fails unless
# the tolerance flags it.
FIR_TOL = 1e-5          # the FIR at the ASR path's shape, float32
# phase A1's FIR cases: every row dtype the kernel takes, at the tap
# counts of the one chunk (2, 11) and of the chunked taps (65, 255, 2048)
FIR_DTYPES = ("float32", "bfloat16", "float16", "int8", "uint8", "int16",
              "int32")
FIR_TAPS = (2, 11, 65, 255, 2048)
# phase A1's FFT cases (N, rows): rows that no block's rows divide; past
# 8192 points the four-step transform, and one float32 row of 2^24
FFT_DTYPES = ("float32", "bfloat16", "float16")
FFT_CASES = [(2, 301), (4, 61), (8, 61), (32, 61), (256, 61), (512, 61),
             (2048, 61), (4096, 61), (8192, 61)]
FOUR_STEP_CASES = [(1 << 14, 17), (1 << 15, 9), (1 << 16, 5), (1 << 17, 3),
                   (1 << 18, 2), (1 << 19, 2), (1 << 20, 2)]
FFT_BIG = 1 << 24
# shuffle: bitwise. RoPE: max |kernel - plain| <= tol * max |plain| (the
# same float32 operations in the same order and the same expf/sinf/cosf;
# bfloat16 within one rounding). Attention: |kernel - plain| <= atol + rtol
# |plain| per element, (atol, rtol) = `FLASH_TOL` of
# kernels/flash_attention/kernel.py, which says why. A kernel that drops
# one 64-key tile from every row's band moves outputs by ~1e-2 at these
# sizes: `dropped_tile_reading` measures that on every run and the run
# fails unless this tolerance flags it.
ROPE_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# RoPE's shared tables invite one fault above all: a slot's heads rotated
# by another slot's table. `rope.cu` patched to build slot s's table from
# slot s + 1's position is built beside the kernels; phase S runs it at R1
# and the run fails unless `ROPE_TOL` flags what it gives.
ROPE_WRONG_SLOT = ("position(pos, pos_dtype, slot0 + sl)",
                   "position(pos, pos_dtype, min(slot0 + sl + 1, slots - 1))")
FLASH_DROP_TILE = 64
SHUFFLE_HALVES = ("both", "lower", "upper")
# phase A3's attention shapes: (B, Sq, Skv, H, KV, dh), causal, window,
# the standard deviation of q and k (sqrt(8): scores to about +-30,
# where exp amplifies an error in a score the most)
FLASH_EDGES = [((2, 128, 128, 4, 2, 64), True, None, 1.0),    # GQA
               ((1, 200, 200, 4, 1, 120), True, None, 1.0),   # MQA, S % 64
               ((2, 256, 256, 4, 2, 32), True, 96, 1.0),      # window
               ((1, 150, 150, 2, 2, 24), True, 32, 1.0),      # dh 24
               ((1, 96, 160, 4, 2, 64), False, None, 1.0),    # Sq < Skv
               ((1, 160, 96, 4, 4, 128), False, None, 1.0),   # Sq > Skv
               ((1, 100, 100, 2, 1, 256), False, 40, 1.0),    # dh 256
               ((1, 130, 130, 4, 2, 20), True, None, 1.0),    # 40-byte rows
               ((1, 1, 777, 4, 2, 64), False, None, 1.0),     # Sq 1
               ((1, 64, 4096, 4, 2, 64), True, 64, 1.0),      # off-band tiles
               ((8, 65, 65, 32, 8, 64), True, None, 1.0),     # many heads
               ((1, 150, 150, 4, 2, 200), True, None, 1.0),   # dh 200
               ((1, 90, 90, 2, 1, 18), True, None, 1.0),      # 4-byte copies
               ((1, 90, 90, 2, 1, 25), False, 30, 1.0),       # 2-byte copies
               ((1, 140, 140, 2, 1, 144), True, None, 1.0),   # dh 144
               ((1, 70, 90, 2, 2, 184), False, None, 1.0),    # dh 184
               ((2, 192, 192, 4, 2, 64), True, None, 8 ** 0.5),  # +-30
               ((1, 128, 32768, 4, 2, 64), False, None, 1.0)]   # long
# phase S's attention: tag, (B, S, H, KV, dh), causal, window, chunk,
# dtypes; F1 qwen1.5-0.5b prefill, F2 h2o-danube3-4b at its window, F3
# whisper-medium's encoder over the 1,500 frames of its front-end
FLASH_PATH = [("F1", (4, 2048, 16, 16, 64), True, None, 256,
               ("bfloat16", "float32")),
              ("F2", (1, 8192, 32, 8, 120), True, 4096, 256,
               ("bfloat16", "float32")),
              ("F3", (8, 1500, 16, 16, 64), False, None, 300,
               ("bfloat16", "float32"))]
# phase S's RoPE: tag, q (B, S, H, dh), theta, (layout, dtype) runs; R1
# qwen1.5-0.5b prefill, R2 h2o-danube3-4b
ROPE_PATH = [("R1", (4, 2048, 16, 64), 1e6,
              tuple((lay, dt) for lay in ("neox", "interleaved")
                    for dt in ("float32", "bfloat16"))),
             ("R2", (1, 8192, 32, 120), 1e4, (("neox", "bfloat16"),))]
# phase S2's shuffle: a million VWRs of 128 32-bit words
VWR_ROWS, VWR_WORDS = 1 << 20, 128


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def check_close(name: str, got: dict, want: dict, tol=None) -> float:
    """Raise unless ``got`` matches ``want`` (class exact, floats within
    ``tol``, default `TOL`); returns the largest float difference."""
    import torch

    if sorted(got) != sorted(want):
        raise AssertionError(f"{name}: keys {sorted(got)} != {sorted(want)}")
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}/{k}: {g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}")
        if k == "class":
            if not torch.equal(g, w):
                bad = (g != w).nonzero()[:5].flatten().tolist()
                raise AssertionError(f"{name}/class differs at rows {bad}")
            continue
        atol, rtol = (tol or TOL)[k]
        diff = (g - w).abs()
        lim = atol + rtol * w.abs()
        if not bool((diff <= lim).all()):
            i = int((diff - lim).argmax())
            raise AssertionError(
                f"{name}/{k}: |diff| {diff.flatten()[i].item():.3e} > "
                f"{lim.flatten()[i].item():.3e} at flat index {i}")
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    return worst


def tol_units(got: dict, want: dict, tol=None) -> float:
    """The largest |got - want| / (ATOL + RTOL |want|) of ``tol`` (default
    `TOL`) over features and margin: above 1 where `check_close` fails."""
    r = 0.0
    for k in ("features", "margin"):
        atol, rtol = (tol or TOL)[k]
        r = max(r, float(((got[k] - want[k]).abs()
                          / (atol + rtol * want[k].abs())).max()))
    return r


def byte_tol_control(want: dict) -> float:
    """What `BYTE_TOL`'s check reads, in units of its limit, from the plain
    outputs ``want`` with their features rounded to float16; raises unless
    the check flags it."""
    import torch

    got = dict(want, features=want["features"].to(torch.float16).float())
    r = tol_units(got, want, BYTE_TOL)
    if not r > 1.0:
        raise AssertionError(f"BYTE_TOL misses features rounded to float16 "
                             f"({r:.3f} of its limit)")
    return r


def check_equal(name: str, got: dict, want: dict) -> None:
    import torch

    for k in want:
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"{name}/{k}: not bitwise equal")


def event_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events). The host first enqueues all calls behind a device-side sleep
    longer than the enqueue takes, so the events time the device's work
    and not the host's launch overhead. One warm-up call first."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * host_s + 0.01)))  # >= 2x the enqueue
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Mean wall time of ``fn`` per call, synchronised at the end: what a
    caller pays, launch overhead included."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def extremum_counts(filtered) -> tuple:
    """Per-frame (candidates, extrema) of (R, S) filtered frames, int64
    (R,) tensors: the samples that pass the neighbour and amplitude tests
    of `delineate` (where the refractory window must be reduced) and the
    extrema it keeps (what the gap sums and the median touch)."""
    import torch

    from repro_torch.core.biosignal import MIN_PROMINENCE, delineate

    x = filtered
    prev, nxt = torch.roll(x, 1, dims=-1), torch.roll(x, -1, dims=-1)
    mu = x.mean(dim=-1, keepdim=True)
    hi, lo = x.amax(dim=-1, keepdim=True), x.amin(dim=-1, keepdim=True)
    cand = ((x > prev) & (x >= nxt) & (x > mu + MIN_PROMINENCE * (hi - mu))) \
        | ((x < prev) & (x <= nxt) & (x < mu - MIN_PROMINENCE * (mu - lo)))
    is_max, is_min = delineate(x)
    return cand.sum(dim=-1), is_max.sum(dim=-1) + is_min.sum(dim=-1)


def graph_work(n_frames: int, in_samples: int, outputs: tuple,
               candidates: int, extrema: int, n_taps: int = 11,
               n_classes: int = 2, min_distance: int = 15,
               elem: int = 4) -> tuple:
    """(bytes, operations) the graph needs for ``n_frames`` frames read
    from ``in_samples`` input samples of ``elem`` bytes: each input read
    once (signal and tables), each requested output written once
    (``filtered`` in the signal's dtype). Operations: per sample
    only what every sample needs (FIR multiply-adds, the three reductions,
    the extremum tests, one gap scan per mask); the refractory window at
    each of this data's ``candidates`` and the gap sums and the median at
    each of its ``extrema``; then per frame the segment mean, the Stockham
    FFT, untangle, power, band sums, log1p, the interval statistics and
    the SVM."""
    S, m = WINDOW, FFT // 2
    stages = int(math.log2(m))
    tables = 4 * (n_taps + 2 * stages * (m // 2) + 2 * m + 12 * n_classes
                  + n_classes)
    out_bytes = {"filtered": elem * S, "features": 4 * 12,
                 "margin": 4 * n_classes, "class": 4}
    nbytes = elem * in_samples + tables + n_frames * sum(
        out_bytes[o] for o in outputs)
    ops = 2 * n_taps * S                              # FIR
    data_ops = 0
    if outputs != ("filtered",):
        ops += 3 * S + 6                              # mean, max, min; gates
        ops += 2 * 4 * S                              # extremum tests
        ops += 2 * S                                  # gap scan, both masks
        ops += 2 * 3                                  # mean, rms per mask
        ops += 2 * FFT                                # segment mean, subtract
        ops += stages * (m // 2) * 10                 # butterflies
        ops += m * 14 + 3 * (m + 1) + (m + 1)         # untangle, power, bands
        ops += 6                                      # log1p
        if set(outputs) & {"margin", "class"}:
            ops += 2 * 12 * n_classes + n_classes
        data_ops = candidates * (2 * min_distance + 1)  # window reduce
        data_ops += extrema * (5 + 2)                 # gap sums; selection
    return nbytes, ops * n_frames + data_ops


def bound_ms(nbytes: int, ops: int, peak: float = PEAK_FP32) -> tuple:
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def asr_graph_work(n_frames: int, in_samples: int, outputs: tuple,
                   mel_nnz: int, n_taps: int = 2, n_mels: int = 64,
                   elem: int = 4) -> tuple:
    """(bytes, operations) of the ASR graph for ``n_frames`` frames read
    from ``in_samples`` input samples of ``elem`` bytes: each input read
    once (signal and tables, the dense mel table included), each
    requested output written once (``filtered`` in the signal's dtype).
    Operations per frame: the FIR multiply-adds over the samples an
    output needs (the window for ``filtered``, the FFT segment for
    ``logmel``); for ``logmel`` the Hann product, the Stockham butterflies
    (10 each), the untangle (16 per bin), |X|^2, the mel product over the
    ``mel_nnz`` nonzero weights of this run's filterbank (a multiply-add
    each: the zeros need no work) and log1p."""
    S, N, m = ASR_WINDOW, ASR_WINDOW, ASR_WINDOW // 2
    stages = int(math.log2(m))
    tables = 4 * (n_taps + N + 2 * stages * (m // 2) + 2 * m
                  + (m + 1) * n_mels)
    out_bytes = {"filtered": elem * S, "logmel": 4 * n_mels}
    nbytes = elem * in_samples + tables + n_frames * sum(
        out_bytes[o] for o in outputs)
    ops = 2 * n_taps * (S if "filtered" in outputs else N)
    if "logmel" in outputs:
        ops += N                                      # Hann
        ops += stages * (m // 2) * 10                 # butterflies
        ops += 16 * m + 1 + 3 * (m + 1)               # untangle, power
        ops += 2 * mel_nnz + n_mels                   # mel product, log1p
    return nbytes, ops * n_frames


def fir_work(rows: int, samples: int, n_taps: int, elem: int) -> tuple:
    """(bytes, operations) of a causal FIR over (rows, samples): the input
    read once, the output written once, 2 * n_taps operations a sample."""
    return (2 * elem * rows * samples + 4 * n_taps,
            2 * n_taps * rows * samples)


def fft_work(rows: int, n: int, elem: int) -> tuple:
    """(bytes, operations) of a complex radix-2 FFT over (rows, n) planes:
    two planes read and two written, the kernel's twiddle table read once
    (`stockham_table`, past 8192 points `four_step_table`: the plain
    version's (log2 n, n/2) one would outweigh the planes of one long
    row), 10 operations a butterfly."""
    from repro_torch.kernels.fft.kernel import (ROW_MAX_N, four_step_table,
                                                stockham_table)

    stages = int(math.log2(n))
    table = stockham_table(n) if n <= ROW_MAX_N else four_step_table(n)
    return (4 * elem * rows * n + table.nbytes,
            10 * stages * (n // 2) * rows)


def synthetic_audio(n: int, seed: int, device):
    """``n`` samples of a 16 kHz speech-band stand-in, made on the device
    from ``seed``: a 220 Hz tone under a slow envelope, a frequency-
    modulated 1.25 kHz tone and white noise; float32 within about
    [-1, 1]."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.arange(n, device=device, dtype=torch.float64) / ASR_RATE
    x = 0.5 * (0.5 + 0.5 * torch.sin(2 * math.pi * 0.3 * t)) * \
        torch.sin(2 * math.pi * 220.0 * t)
    x += 0.3 * torch.sin(2 * math.pi * 1250.0 * t
                         + 2.0 * torch.sin(2 * math.pi * 0.1 * t))
    del t
    return x.float() + 0.05 * torch.randn(n, generator=g, device=device)


def check_asr(name: str, got: dict, want: dict) -> float:
    """Raise unless the ASR outputs ``got`` match ``want``: filtered
    bitwise, logmel within `ASR_LOGMEL_TOL` of the largest |want|;
    returns the largest logmel difference."""
    from repro_torch.kernels.pipeline.asr import ASR_LOGMEL_TOL

    if sorted(got) != sorted(want):
        raise AssertionError(f"{name}: keys {sorted(got)} != {sorted(want)}")
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}/{k}: {g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}")
        if not bool(g.isfinite().all()):
            raise AssertionError(f"{name}/{k}: non-finite values")
        if k == "filtered":
            if not bool((g == w).all()):
                raise AssertionError(f"{name}/filtered: not bitwise equal")
            continue
        diff = float((g - w).abs().max())
        scale = max(1.0, float(w.abs().max()))
        if diff > ASR_LOGMEL_TOL * scale:
            raise AssertionError(f"{name}/logmel: |diff| {diff:.3e} > "
                                 f"{ASR_LOGMEL_TOL} x {scale:.3f}")
        worst = max(worst, diff)
    return worst


def check_scaled(name: str, got, want, tol: float) -> float:
    """Raise unless max |got - want| <= tol * max |want|, in float32;
    returns the max |difference|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    diff = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if not diff <= tol * scale:
        raise AssertionError(f"{name}: |diff| {diff:.3e} > {tol} x "
                             f"{scale:.3e}")
    return diff


def scaled_ratio(got: tuple, want: tuple) -> float:
    """max over the planes of max |got - want| / max |want|, in float32:
    what `check_scaled` holds to a tolerance, plane by plane."""
    return max(float((g.float() - w.float()).abs().max()) /
               float(w.float().abs().max()) for g, w in zip(got, want))


def wrong_fft_reading(re, im, want: tuple, *, inverse: bool = False) -> \
        float:
    """What the FFT check reads from a transform whose first stage's
    twiddles are conjugated: `fft_stages` on a `twiddle_table` so modified,
    rounded to the input's dtype, against ``want`` (the plain output);
    returns max over the planes of max |diff| / max |want|."""
    import torch

    from repro_torch.core.fft import fft_stages
    from repro_torch.kernels.fft.kernel import twiddle_table

    n = re.shape[-1]
    wr, wi = (torch.as_tensor(a, device=re.device)
              for a in twiddle_table(n, inverse))
    wi[0] = -wi[0]
    rr, ri = fft_stages(re.float(), im.float(), table=(wr, wi))
    if inverse:
        rr, ri = rr / n, ri / n
    return scaled_ratio((rr.to(re.dtype), ri.to(re.dtype)), want)


def wrong_four_step_reading(re, im, want: tuple, *,
                            inverse: bool = False) -> float:
    """What the FFT check reads from a four-step transform without its
    inter-pass twiddle (`four_step_model` with ``twiddle=False``), rounded
    to the input's dtype, against ``want``; max over the planes of max
    |diff| / max |want|."""
    from repro_torch.kernels.fft.kernel import four_step_model

    got = four_step_model(re, im, inverse=inverse, twiddle=False)
    return scaled_ratio(tuple(a.to(re.dtype) for a in got), want)


def check_wrong_fft(name: str, re, im, want: tuple, inverse: bool) -> float:
    """Raise unless `FFT_TOL` flags `wrong_fft_reading` for this case and,
    past `ROW_MAX_N`, `wrong_four_step_reading`; returns the least
    reading."""
    from repro_torch.kernels.fft.kernel import FFT_TOL, ROW_MAX_N

    tol = FFT_TOL[str(re.dtype).replace("torch.", "")]
    readings = {"a conjugated first stage": wrong_fft_reading(
        re, im, want, inverse=inverse)}
    if re.shape[-1] > ROW_MAX_N:
        readings["the four-step without its twiddle"] = \
            wrong_four_step_reading(re, im, want, inverse=inverse)
    for what, reading in readings.items():
        if not reading > tol:
            raise AssertionError(f"{name}: {what} reads {reading:.3e} <= "
                                 f"tol {tol}: the check would not see it")
    return min(readings.values())


def fir_rows(shape: tuple, dtype, g):
    """FIR rows of ``dtype`` from the generator ``g``: a normal draw for a
    float dtype; for an integer one the draw at full scale about the
    middle of the range plus a square wave of period 74, saturated into
    it (`full_scale`), so the filters pass the range."""
    import torch

    x = torch.randn(shape, generator=g, device=g.device)
    if dtype.is_floating_point:
        return x.to(dtype)
    return full_scale(x.flatten(), dtype).reshape(shape)


def check_fir(name: str, got, want) -> float:
    """Raise unless the FIR kernel's ``got`` is bitwise the plain
    version's ``want`` (the same float32 operations in the same order,
    the same store); returns the max |difference|, 0."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    if not torch.equal(got, want):
        diff = (got.double() - want.double()).abs()
        raise AssertionError(f"{name}: not bitwise the plain version: "
                             f"{int((diff > 0).sum())} outputs differ, max "
                             f"|diff| {float(diff.max()):.3e}")
    return 0.0


def wrong_biosignal_readings(sig, graph, operands, want) -> dict:
    """What phase 2's check reads against ``want`` (the plain outputs of
    ``sig`` at window 2048, hop 512, `filtered` among them), from the plain
    stage bodies given a wrong step: ``second_pass_conjugated``, the
    radix-2 chain's stages 4 to 7 (those the kernel's second pass of four
    computes at fft 512) with conjugated twiddles; ``median_rank_high``,
    each mask's median taken one rank high (the (k + 1)-th smallest gap, k
    = (n - 1) // 2, where n > 1), the margin and class recomputed. Each
    reading is (the largest |diff| / (ATOL + RTOL |want|) of `TOL` over
    features and margin, above 1 where the check flags it; the share of
    rows whose class differs)."""
    import torch

    from repro_torch.core.biosignal import (_interval_gaps, delineate,
                                            svm_predict)
    from repro_torch.kernels.pipeline.graph import graph_stream_plain

    taps, wr, wi, u, w, b = operands
    wi2 = wi.clone()
    wi2[4:8] = -wi2[4:8]
    conj = graph_stream_plain(sig, (taps, wr, wi2, u, w, b), graph=graph,
                              window=WINDOW, hop=HOP,
                              outputs=("features", "margin", "class"))
    feats = want["features"].clone()
    for col, mask in zip((1, 4), delineate(want["filtered"])):
        gaps, valid = _interval_gaps(mask)
        nv = valid.sum(dim=-1)
        ordered = torch.where(valid, gaps, WINDOW + 1).sort(dim=-1).values
        k = torch.minimum((nv.clamp(min=1) - 1) // 2 + 1,
                          (nv - 1).clamp(min=0))
        med = ordered.gather(-1, k[:, None])[:, 0]
        feats[:, col] = torch.where(nv > 0, med, 0).to(torch.float32)
    margin, cls = svm_predict(feats, w, b)
    readings = {}
    for name, got in (("second_pass_conjugated", conj),
                      ("median_rank_high", {"features": feats,
                                            "margin": margin,
                                            "class": cls})):
        readings[name] = (tol_units(got, want),
                          float((got["class"] != want["class"]).float()
                                .mean()))
    return readings


def wrong_asr_readings(sig, asr_graph, asr_ops, want) -> dict:
    """What the ASR check reads, max |diff| / max(1, max |want|) against
    ``want`` (the plain logmel of ``sig``), from the plain stage bodies
    given wrong tables: ``second_pass_conjugated``, the radix-2 chain's
    stages 4 to 7 (those the kernel's second radix-16 pass computes at fft
    512) with conjugated twiddles; ``mel_span_short``, every mel column's
    last nonzero weight dropped."""
    from repro_torch.kernels.pipeline.asr import span_table
    from repro_torch.kernels.pipeline.graph import graph_stream_plain

    taps, hann, wr, wi, u, mel_w = asr_ops
    wi2 = wi.clone()
    wi2[4:8] = -wi2[4:8]
    first, offset, _ = span_table(mel_w.cpu().numpy())
    short = mel_w.clone()
    for j, (k0, n) in enumerate(zip(first, offset[1:] - offset[:-1])):
        if n:
            short[k0 + n - 1, j] = 0.0
    scale = max(1.0, float(want.abs().max()))
    readings = {}
    for name, ops in (
            ("second_pass_conjugated", (taps, hann, wr, wi2, u, mel_w)),
            ("mel_span_short", (taps, hann, wr, wi, u, short))):
        got = graph_stream_plain(sig, ops, graph=asr_graph, window=ASR_WINDOW,
                                 hop=ASR_HOP, outputs=("logmel",))["logmel"]
        readings[name] = float((got - want).abs().max()) / scale
    return readings


def counted(fn):
    """Run ``fn()`` with every launch count set to 0 just before; return
    (its result, the counts just after)."""
    import torch

    from repro_torch.kernels import _cuda

    torch.cuda.synchronize()
    _cuda.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, copy.deepcopy(_cuda.LAUNCHES)


def expect_launches(tag: str, got: dict, want: dict) -> None:
    """Raise unless ``got`` (kernel -> entry -> count) holds exactly the
    ``want`` counts ({(kernel, entry): n}) and zero elsewhere."""
    for kernel, entries in got.items():
        for entry, n in entries.items():
            if n != want.get((kernel, entry), 0):
                raise AssertionError(f"{tag}: launches {got}, expected "
                                     f"{want}")


def biosignal_kernels_vs_plain(app, graph, operands, dev) -> dict:
    """Phase 2: the biosignal kernel against its plain version at every
    entry and output selection; returns max |diff| per entry."""
    import torch

    from repro_torch.core.biosignal import synthetic_respiration
    from repro_torch.kernels.pipeline.graph import (
        graph_frames_call, graph_frames_plain, graph_ring_call,
        graph_ring_plain, graph_stream_call, graph_stream_plain,
        ring_chunk_samples)
    from repro_torch.kernels.pipeline.kernel import OUTPUTS
    from repro_torch.serve.stream import frame_signal

    n_cmp = 64
    cmp_sig = synthetic_respiration(1, (n_cmp - 1) * HOP + WINDOW, seed=1,
                                    device=dev)[0][0]
    frames = frame_signal(cmp_sig, WINDOW, HOP)
    bw, depth = 8, 4
    span, stride = ring_chunk_samples(WINDOW, HOP, bw), bw * HOP
    ring = torch.stack([cmp_sig[r * stride: r * stride + span]
                        for r in range(depth)])
    selections = [OUTPUTS, ("features", "margin", "class"), ("filtered",),
                  ("features",), ("margin",), ("class",)]
    max_err = {"frames": 0.0, "stream": 0.0, "ring": 0.0}
    plain_all = None
    for sel in selections:
        kw = dict(graph=graph, outputs=sel)
        ks = graph_stream_call(cmp_sig, operands, window=WINDOW, hop=HOP,
                               **kw)
        kf = graph_frames_call(frames, operands, **kw)
        kr = graph_ring_call(ring, operands, window=WINDOW, hop=HOP, **kw)
        torch.cuda.synchronize()
        ps = graph_stream_plain(cmp_sig, operands, window=WINDOW, hop=HOP,
                                **kw)
        pf = graph_frames_plain(frames, operands, **kw)
        pr = graph_ring_plain(ring, operands, window=WINDOW, hop=HOP, **kw)
        if sel == OUTPUTS:
            plain_all = ps
        max_err["stream"] = max(max_err["stream"],
                                check_close(f"stream{sel}", ks, ps))
        max_err["frames"] = max(max_err["frames"],
                                check_close(f"frames{sel}", kf, pf))
        max_err["ring"] = max(max_err["ring"],
                              check_close(f"ring{sel}", kr, pr))
        check_equal(f"stream==framed{sel}", ks, kf)
        for r in range(depth):
            one = graph_stream_call(ring[r], operands, window=WINDOW,
                                    hop=HOP, **kw)
            check_equal(f"ring[{r}]==stream{sel}",
                        {k: v[r] for k, v in kr.items()}, one)
    wrong = wrong_biosignal_readings(cmp_sig, graph, operands, plain_all)
    for name, (reading, _) in wrong.items():
        if not reading > 1.0:
            raise AssertionError(f"biosignal {name} reads {reading:.3e} x "
                                 f"TOL: the check would not see it")
    max_err["biosignal wrong readings"] = wrong
    print(f"biosignal kernel vs plain on the card: {len(selections)} output "
          f"selections x (frames, stream, ring) at window {WINDOW} hop "
          f"{HOP}, {n_cmp} frames: class exact, max |diff| "
          f"frames {max_err['frames']:.3e} stream {max_err['stream']:.3e} "
          f"ring {max_err['ring']:.3e}; stream == framed == ring slot "
          f"bitwise; the plain stage bodies would read "
          + ", ".join(f"{k} {r:.3e} x TOL (class differs in {c:.3f} of "
                      f"rows)" for k, (r, c) in wrong.items())
          + " (both flagged)")
    return max_err


def asr_kernels_vs_plain(asr_graph, asr_ops, dev) -> dict:
    """Phase A1: the ASR graph, FIR and FFT kernels against their plain
    versions; returns max |diff| per kernel (and ASR entry)."""
    import torch

    from repro_torch.core.fir import lowpass_taps
    from repro_torch.kernels.fft.kernel import (FFT_TOL, ROW_MAX_N,
                                                device_twiddles, fft_cuda,
                                                fft_plain)
    from repro_torch.kernels.fir.kernel import fir_cuda, fir_plain
    from repro_torch.kernels.pipeline.asr import ASR_LOGMEL_TOL
    from repro_torch.kernels.pipeline.graph import (
        graph_frames_call, graph_frames_plain, graph_ring_call,
        graph_ring_plain, graph_stream_call, graph_stream_plain,
        ring_chunk_samples)
    from repro_torch.serve.stream import frame_signal

    W, H = ASR_WINDOW, ASR_HOP
    n_cmp = 70
    sig = synthetic_audio((n_cmp - 1) * H + W, seed=1, device=dev)
    frames = frame_signal(sig, W, H)
    bw, depth = 16, 4
    span, stride = ring_chunk_samples(W, H, bw), bw * H
    ring = sig[: (depth - 1) * stride + span].as_strided((depth, span),
                                                         (stride, 1))
    err = {"asr_graph[frames]": 0.0, "asr_graph[stream]": 0.0,
           "asr_graph[ring]": 0.0}
    selections = [("filtered", "logmel"), ("logmel",), ("filtered",)]
    for sel in selections:
        kw = dict(graph=asr_graph, outputs=sel)
        for entry, k, p in (
                ("stream",
                 graph_stream_call(sig, asr_ops, window=W, hop=H, **kw),
                 graph_stream_plain(sig, asr_ops, window=W, hop=H, **kw)),
                ("frames", graph_frames_call(frames, asr_ops, **kw),
                 graph_frames_plain(frames, asr_ops, **kw)),
                ("ring",
                 graph_ring_call(ring, asr_ops, window=W, hop=H, **kw),
                 graph_ring_plain(ring, asr_ops, window=W, hop=H, **kw))):
            tag = f"asr_graph[{entry}]"
            err[tag] = max(err[tag], check_asr(f"{tag}{sel}", k, p))
            if entry == "stream":
                ks = k
            elif entry == "frames":
                check_equal(f"asr stream==framed{sel}", ks, k)
            else:
                check_equal(f"asr ring==stream{sel}",
                            {o: v.reshape(-1, *v.shape[2:])
                             for o, v in k.items()},
                            {o: v[: depth * bw] for o, v in ks.items()})
    g = torch.Generator(device=dev).manual_seed(3)
    # the FIR: every dtype and tap count, rows longer than one tile; the
    # kernel repeats the plain version's float32 operations in its order
    # and stores as it stores, so the two must agree bitwise
    err["fir[rows]"] = 0.0
    n_fir, fir_rails = 0, 0
    for dname in FIR_DTYPES:
        dtype = getattr(torch, dname)
        for k in FIR_TAPS:
            x = fir_rows((5, 5000), dtype, g)
            taps = torch.as_tensor(lowpass_taps(k, cutoff=min(0.4, 8.0 / k)),
                                   device=dev)
            got = fir_cuda(x, taps, seq_block=2048)      # 3 tiles a row
            want = fir_plain(x, taps)
            err["fir[rows]"] = max(err["fir[rows]"], check_fir(
                f"fir {dname} k={k}", got, want))
            if not dtype.is_floating_point:
                fir_rails += int(((want == torch.iinfo(dtype).max) |
                                  (want == torch.iinfo(dtype).min)).sum())
            n_fir += 1
    err["fir rails"] = fir_rails
    # the FFT: one launch to 8192 points, the four-step past it, in every
    # dtype both ways; each case also as a wrong transform would read it
    err["fft[rows]"] = 0.0
    n_fft = 0
    ratio = {d: 0.0 for d in FFT_DTYPES}
    wrong = {d: math.inf for d in FFT_DTYPES}
    for n, rows in FFT_CASES + FOUR_STEP_CASES:
        for dname in FFT_DTYPES:
            dtype = getattr(torch, dname)
            re = torch.randn(rows, n, generator=g, device=dev).to(dtype)
            im = torch.randn(rows, n, generator=g, device=dev).to(dtype)
            for inverse in (False, True):
                tag = f"fft {dname} N={n} inverse={inverse}"
                got, launched = counted(lambda: fft_cuda(re, im,
                                                         inverse=inverse))
                expect_launches(tag, launched, {
                    ("fft", "rows"): 1} if n <= ROW_MAX_N else {
                    ("fft", "four_step_columns"): 1,
                    ("fft", "four_step_rows"): 1})
                want = fft_plain(re, im, inverse=inverse)
                for a, b in zip(got, want):
                    err["fft[rows]"] = max(err["fft[rows]"], check_scaled(
                        tag, a, b, FFT_TOL[dname]))
                ratio[dname] = max(ratio[dname], scaled_ratio(got, want))
                if n > 2:      # N = 2 has no twiddle but 1 to conjugate
                    wrong[dname] = min(wrong[dname], check_wrong_fft(
                        tag, re, im, want, inverse))
                n_fft += 1
    err["fft ratio"], err["fft wrong reading"] = ratio, wrong
    # one row of 2^24 points in float32: the plain version's packed table
    # takes 1.6 GB on the card, built once and dropped after
    re = torch.randn(1, FFT_BIG, generator=g, device=dev)
    im = torch.randn(1, FFT_BIG, generator=g, device=dev)
    for inverse in (False, True):
        got = fft_cuda(re, im, inverse=inverse)
        want = fft_plain(re, im, inverse=inverse)
        for a, b in zip(got, want):
            err["fft[rows]"] = max(err["fft[rows]"], check_scaled(
                f"fft float32 N={FFT_BIG} inverse={inverse}", a, b,
                FFT_TOL["float32"]))
        err[f"fft ratio N={FFT_BIG} inverse={inverse}"] = scaled_ratio(
            got, want)
        n_fft += 1
    del re, im, got, want
    device_twiddles.cache_clear()
    torch.cuda.empty_cache()
    plain = graph_stream_plain(sig, asr_ops, graph=asr_graph, window=W,
                               hop=H, outputs=("logmel",))["logmel"]
    asr_wrong = wrong_asr_readings(sig, asr_graph, asr_ops, plain)
    for name, reading in asr_wrong.items():
        if not reading > ASR_LOGMEL_TOL:
            raise AssertionError(f"asr {name} reads {reading:.3e} <= tol "
                                 f"{ASR_LOGMEL_TOL}: the check would not "
                                 f"see it")
    err["asr wrong readings"] = asr_wrong
    print(f"ASR graph vs plain on the card: {len(selections)} output "
          f"selections x (frames, stream, ring) at window {W} hop {H}, "
          f"{n_cmp} frames: filtered bitwise, logmel max |diff| "
          + ", ".join(f"{e} {err[f'asr_graph[{e}]']:.3e}"
                      for e in ("frames", "stream", "ring"))
          + f" (tol {ASR_LOGMEL_TOL} x max(1, max|logmel|)); stream == "
          f"framed == ring slot bitwise; the plain stage bodies would read "
          + ", ".join(f"{k} {v:.3e}" for k, v in asr_wrong.items())
          + " (both flagged)")
    print(f"FIR vs plain: {n_fir} cases ({'/'.join(FIR_DTYPES)} x "
          f"{'/'.join(str(k) for k in FIR_TAPS)} taps, rows of 5000 over "
          f"2048-sample tiles, integers at full scale: {fir_rails} outputs "
          f"at the rails), all bitwise the plain version; FFT vs plain: "
          f"{n_fft} cases (N "
          f"{'/'.join(str(n) for n, _ in FFT_CASES + FOUR_STEP_CASES)} x "
          f"{'/'.join(FFT_DTYPES)} x forward/inverse, past {ROW_MAX_N} two "
          f"launches each, and N {FFT_BIG} in float32), max |diff| "
          f"{err['fft[rows]']:.3e}; max |diff| / max |plain| " + ", ".join(
              f"{k} {v:.3e}" for k, v in ratio.items())
          + f", N {FFT_BIG} " + "/".join(
              f"{err[f'fft ratio N={FFT_BIG} inverse={i}']:.3e}"
              for i in (False, True))
          + f" (tol {FFT_TOL}); a wrong transform (a conjugated first "
          f"stage; past {ROW_MAX_N} also the four-step without its "
          f"inter-pass twiddle) reads at least "
          + ", ".join(f"{k} {v:.3e}" for k, v in wrong.items())
          + " (flagged in every case from N 4)")
    return err


# ---------------------------------------------------------------------------
# The standalone shuffle-unit, RoPE and flash-attention kernels
# ---------------------------------------------------------------------------

def shuffle_work(rows: int, out_n: int, elem: int) -> tuple:
    """(bytes, operations) of one shuffle: a permutation, so each output
    word is one word of A or B, read once, and is written once; the words
    no output takes (the other half, the pruned words) need not move. No
    arithmetic on the data."""
    return 2 * elem * rows * out_n, 0


def rope_work(rows: int, n_pos: int, dh: int, elem: int,
              pos_elem: int) -> tuple:
    """(bytes, operations) of the rotary pass over ``rows`` rows that share
    ``n_pos`` positions: x read and written once, each position read once;
    the dh/2 inverse frequencies (2 products each), one angle per position
    and frequency, and per pair the rotation (4 products, 2 sums); the
    exp, sin and cos are not counted."""
    half = dh // 2
    return (2 * elem * rows * dh + pos_elem * n_pos,
            2 * half + n_pos * half + 6 * rows * half)


def declare_rope_wrong_slot() -> None:
    """Declare ``rope_wrong_slot``, `rope.cu` with `ROPE_WRONG_SLOT`
    applied and the error-string symbol `_cuda` looks for under that name
    added (written under build/chip_smoke/), to `_cuda`, so that
    `build_all` builds it beside the kernels; its one entry is not a path's
    and phase S launches it only to measure what the check reads."""
    from repro_torch.kernels import _cuda

    text = (ROOT / ROPE_SOURCE).read_text()
    old, new = ROPE_WRONG_SLOT
    if text.count(old) != 1:
        raise AssertionError(f"{ROPE_SOURCE}: {old!r} is not in it once")
    path = ROOT / "build" / "chip_smoke" / "rope_wrong_slot.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text.replace(old, new) + (
        '\nextern "C" const char* rope_wrong_slot_error_string(int code) {\n'
        '  return rope_error_string(code);\n}\n'))
    _cuda.declare("rope_wrong_slot", path, ("wrong_slot",),
                  _cuda.KERNELS["rope"].signatures)


def wrong_slot_reading(x, pos, want, *, theta: float, layout: str,
                       heads: int) -> float:
    """What the RoPE check reads from ``rope_wrong_slot`` on these inputs:
    max |diff| / max |want| against ``want``, the plain output."""
    import torch

    from repro_torch.kernels import _cuda
    from repro_torch.kernels.rope.kernel import rope_launch_args

    out = torch.empty_like(x)
    _cuda.launch("rope_wrong_slot", "wrong_slot", x, "rope_launch",
                 *rope_launch_args(x, pos, out, theta=theta, layout=layout,
                                   heads=heads))
    return scaled_ratio((out,), (want,))


def shuffle_library(a, b, op: str, half: str, amount: int):
    """One PyTorch call that computes ``shuffle(a, b, op, half=half,
    amount=amount)`` on (R, N) blocks of even N, as a function, or None
    where there is none (`bit_reverse`). The interleave is `torch.stack`
    of the two blocks (or of their halves) on a new last axis, viewed as
    (R, out_n); a prune `torch.cat` of the kept words of each; a circular
    shift by 0 < k <= N `torch.cat` of the three runs of words it moves
    (other amounts need other slices: phase S shifts by 32 only)."""
    import torch

    R, n = a.shape
    k = amount % (2 * n)
    if op == "interleave":
        cut = {"both": slice(0, n), "lower": slice(0, n // 2),
               "upper": slice(n // 2, n)}[half]
        width = 2 * n if half == "both" else n
        return lambda: torch.stack((a[:, cut], b[:, cut]), -1).view(R,
                                                                    width)
    if op in ("prune_even", "prune_odd"):
        c = 1 if op == "prune_even" else 0     # prune_even keeps odd words
        return lambda: torch.cat((a[:, c::2], b[:, c::2]), 1)
    if op == "circular_shift":
        if not 0 < k <= n:
            raise ValueError(f"shuffle_library: shift {k} outside (0, {n}]")
        runs = {"both": (b[:, n - k:], a, b[:, : n - k]),
                "lower": (b[:, n - k:], a[:, : n - k]),
                "upper": (a[:, n - k:], b[:, : n - k])}[half]
        return lambda: torch.cat(runs, 1)
    return None


def live_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """The (query, key) pairs of one head that the mask keeps."""
    import numpy as np

    qpos = np.arange(sq, dtype=np.int64)
    hi = np.minimum(qpos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, qpos - window + 1) if window is not None else 0
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_work(B: int, sq: int, skv: int, H: int, KV: int, dh: int,
               elem: int, causal: bool, window) -> tuple:
    """(bytes, operations) of attention: q, k, v read once and the output
    written once; 4 dh operations per live (query, key) pair (the QK^T and
    PV products), over this run's mask."""
    nbytes = elem * dh * (2 * B * sq * H + 2 * B * skv * KV)
    return nbytes, 4 * dh * B * H * live_pairs(sq, skv, causal, window)


def plain_attention_by_group(q, k, v, *, causal: bool, window=None):
    """`flash_attention_plain` one kv head (and its group of query heads)
    at a time, so the O(S^2) score tensor of one group fits; rows cannot
    be split, since positions count from 0."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_plain

    KV, G = k.shape[2], q.shape[2] // k.shape[2]
    out = torch.empty_like(q)
    for h in range(KV):
        out[:, :, h * G:(h + 1) * G] = flash_attention_plain(
            q[:, :, h * G:(h + 1) * G], k[:, :, h:h + 1], v[:, :, h:h + 1],
            causal=causal, window=window)
    return out


def ptxas_summary(kernel: str, log: str) -> str:
    """One line from ``nvcc -Xptxas -v``: the kernel's instantiations, their
    register range and those that spill (bytes of spill stores); the flash
    kernel's are named by namespace and template arguments, tc<dh padded
    to 8, TMA> and f32<dh padded to 32>."""
    import re

    regs, spills, f32_regs, name = [], {}, {}, ""
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", ln)
        if m:
            t = re.search(r"(tc|f32)12flash_kernelILi(\d+)E(?:Lb(\d))?",
                          m.group(1))
            args = ",".join(x for x in t.groups()[1:] if x) if t else ""
            name = f"{t.group(1)}<{args}>" if t else m.group(1)
        if m := re.search(r"Used (\d+) registers", ln):
            regs.append(int(m.group(1)))
            if name.startswith("f32<"):
                f32_regs[name] = int(m.group(1))
        if (m := re.search(r"(\d+) bytes spill stores", ln)) and \
                int(m.group(1)):
            spills[name] = int(m.group(1))
    if not regs:
        return f"ptxas {kernel}: no register report (cached build)"
    return (f"ptxas {kernel}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
            f"registers, spill stores " +
            (", ".join(f"{k} {v} B" for k, v in spills.items()) or "none")
            + ("; registers " + ", ".join(f"{k} {v}" for k, v in
                                          f32_regs.items())
               if f32_regs else ""))


def sass_summary(lib: Path) -> str:
    """One line from ``cuobjdump -sass`` of the flash-attention library:
    for each float32 instantiation (namespace f32, by dh padded to 32) its
    HGMMA (wgmma) instructions by opcode and its FFMA count. Raises unless
    every float32 instantiation issues TF32 HGMMA: the float32 path runs
    on the tensor cores, with no CUDA-core product loop left."""
    import re
    import shutil

    from repro_torch.kernels import _cuda

    tool = shutil.which("cuobjdump") or str(Path(_cuda._nvcc()).parent /
                                            "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    per, name = {}, None
    for ln in sass.splitlines():
        if m := re.search(r"Function : (\S+)", ln):
            t = re.search(r"3f3212flash_kernelILi(\d+)E", m.group(1))
            name = f"f32<{t.group(1)}>" if t else None
            if name:
                per[name] = {"hgmma": {}, "ffma": 0}
        elif name:
            if m := re.search(r"\b(HGMMA\.\S+)", ln):
                op = m.group(1)
                per[name]["hgmma"][op] = per[name]["hgmma"].get(op, 0) + 1
            elif re.search(r"\bFFMA\b", ln):
                per[name]["ffma"] += 1
    if not per:
        raise AssertionError("cuobjdump: no float32 flash kernel in "
                             f"{lib.name}")
    for k, v in per.items():
        if not any("TF32" in op for op in v["hgmma"]):
            raise AssertionError(f"sass {k}: no TF32 HGMMA ({v})")
    return "sass flash_attention float32: " + "; ".join(
        f"{k} " + ", ".join(f"{op} x{n}" for op, n in v["hgmma"].items())
        + f", FFMA x{v['ffma']}" for k, v in per.items())


def check_bitwise(name: str, got, want) -> None:
    """Raise unless ``got`` and ``want`` hold the same words."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    view = torch.int32 if got.element_size() == 4 else torch.int16
    if not torch.equal(got.view(view), want.view(view)):
        raise AssertionError(f"{name}: not bitwise equal")


def check_elementwise(name: str, got, want, tol: tuple) -> float:
    """Raise unless |got - want| <= atol + rtol |want| everywhere (in
    float32), ``tol = (atol, rtol)``, and got is finite; returns the max
    |difference|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    g, w = got.float(), want.float()
    if not bool(g.isfinite().all()):
        raise AssertionError(f"{name}: non-finite values")
    atol, rtol = tol
    diff = (g - w).abs()
    excess = diff - (atol + rtol * w.abs())
    if bool((excess > 0).any()):
        i = int(excess.argmax())
        raise AssertionError(f"{name}: |diff| {diff.flatten()[i].item():.3e}"
                             f" > {atol} + {rtol} x |plain| "
                             f"{w.flatten()[i].abs().item():.3e} at flat "
                             f"index {i}")
    return float(diff.max())


def dropped_tile_reading(q, k, v, want, *, causal: bool, window,
                         tol: tuple) -> tuple:
    """What the attention check reads from a kernel that skips one
    `FLASH_DROP_TILE`-key tile of every row's band (the tile before the
    one holding the row's newest key): that output is made in plain
    PyTorch for the first kv head and its group of query heads, rounded to
    q's dtype and held against ``want``, the plain output. Returns (max
    |diff|, the share of those outputs that ``tol`` flags)."""
    import torch

    from repro_torch.models.attention import NEG_INF

    B, sq, H, dh = q.shape
    skv, G = k.shape[1], H // k.shape[2]
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    newest = qp.clamp(max=skv - 1) if causal else \
        torch.full_like(qp, skv - 1)
    mask = kp // FLASH_DROP_TILE != newest // FLASH_DROP_TILE - 1
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    s = torch.einsum("bqhd,bsd->bhqs", q[:, :, :G].float(),
                     k[:, :, 0].float()) / math.sqrt(dh)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    del s
    out = torch.einsum("bhqs,bsd->bqhd", p, v[:, :, 0].float()).to(q.dtype)
    w = want[:, :, :G].float()
    diff = (out.float() - w).abs()
    flagged = diff > tol[0] + tol[1] * w.abs()
    return float(diff.max()), float(flagged.float().mean())


def tf32_round(x):
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: to
    nearest on the int32 view, ties away from zero, the low 13 bits 0."""
    import torch

    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def one_product_reading(q, k, v, want, *, causal: bool, window,
                        tol: tuple) -> tuple:
    """What the float32 attention check reads from a kernel that runs one
    TF32 product per matrix product instead of three: the plain version's
    arithmetic on q (scaled), k, the unnormalised p and v each rounded once
    to TF32 (`tf32_round`), for the first kv head and its group of query
    heads, held against ``want``, the plain output. Returns (max |diff|,
    the share of those outputs that ``tol`` flags)."""
    import torch

    from repro_torch.models.attention import NEG_INF

    B, sq, H, dh = q.shape
    skv, G = k.shape[1], H // k.shape[2]
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    qs = tf32_round(q[:, :, :G] * (1.0 / math.sqrt(dh)))
    s = torch.einsum("bqhd,bsd->bhqs", qs, tf32_round(k[:, :, 0]))
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    del s
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqs,bsd->bhqd", tf32_round(p),
                       tf32_round(v[:, :, 0])) / l
    del p
    w = want[:, :, :G].float()
    diff = (out.transpose(1, 2) - w).abs()
    flagged = diff > tol[0] + tol[1] * w.abs()
    return float(diff.max()), float(flagged.float().mean())


def standalone_kernels_vs_plain(dev) -> dict:
    """Phase A3: the shuffle, RoPE and flash-attention kernels against
    their plain versions at edge shapes; returns max |diff| per kernel."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import (
        FLASH_TOL, flash_attention_cuda, flash_attention_plain)
    from repro_torch.kernels.rope.kernel import (LAYOUTS, rope_cuda,
                                                 rope_plain)
    from repro_torch.kernels.shuffle.kernel import (OPS, shuffle_cuda,
                                                    shuffle_plain)

    g = torch.Generator(device=dev).manual_seed(13)
    n_shuffle = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        for n in (2, 64, 128, 256):
            if dtype == torch.int32:
                a, b = (torch.randint(-2 ** 31, 2 ** 31 - 1, (37, n),
                                      generator=g, device=dev,
                                      dtype=torch.int32) for _ in range(2))
            else:
                a, b = (torch.randn(37, n, generator=g, device=dev)
                        .to(dtype) for _ in range(2))
            for op in OPS:
                for half in SHUFFLE_HALVES:
                    for amount in (0, 32, -5, 2 * n + 3):
                        check_bitwise(
                            f"shuffle {op} {half} {amount} N={n} {dtype}",
                            shuffle_cuda(a, b, op, half=half, amount=amount),
                            shuffle_plain(a, b, op, half=half,
                                          amount=amount))
                        n_shuffle += 1
    err = {f"{k} {d}": 0.0 for k in ("rope", "flash_attention")
           for d in ("float32", "bfloat16")}
    err["shuffle"] = 0.0
    n_rope = 0
    # one position a row (int32), then one per 3 rows (int64), 5 rows
    # (float32) and 16 rows (int32), the heads of a slot
    heads_pos = ((1, torch.int32), (3, torch.int64), (5, torch.float32),
                 (16, torch.int32))
    for dtype, dh, offset in itertools.product(
            (torch.float32, torch.bfloat16), (18, 32, 120, 128), (0, 1)):
        # offset 1: the base one element into its buffer, where the kernel
        # takes its scalar path
        buf = torch.randn(480 * dh + 1, generator=g, device=dev).to(dtype)
        x = buf[offset: offset + 480 * dh].view(480, dh)
        name = str(dtype).replace("torch.", "")
        for (heads, pdt), layout, theta in itertools.product(
                heads_pos, LAYOUTS, (1e4, 1e6)):
            pos = torch.randint(0, 8192, (480 // heads,), generator=g,
                                device=dev).to(pdt)
            kw = dict(theta=theta, layout=layout, heads=heads)
            err[f"rope {name}"] = max(err[f"rope {name}"], check_scaled(
                f"rope {layout} dh={dh} theta={theta} heads={heads} {pdt} "
                f"{name} offset={offset}", rope_cuda(x, pos, **kw),
                rope_plain(x, pos, **kw), ROPE_TOL[name]))
            n_rope += 1
    n_flash, worst = 0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for (B, sq, skv, H, KV, dh), causal, window, amp in FLASH_EDGES:
            q = (amp * torch.randn(B, sq, H, dh, generator=g, device=dev)) \
                .to(dtype)
            k = (amp * torch.randn(B, skv, KV, dh, generator=g,
                                   device=dev)).to(dtype)
            v = torch.randn(B, skv, KV, dh, generator=g, device=dev) \
                .to(dtype)
            name = str(dtype).replace("torch.", "")
            label = (f"{(B, sq, skv, H, KV, dh)} causal={causal} "
                     f"window={window} sd(q, k)={amp:.3g}")
            e = check_elementwise(
                f"flash {label} {name}",
                flash_attention_cuda(q, k, v, causal=causal, window=window),
                flash_attention_plain(q, k, v, causal=causal, window=window),
                FLASH_TOL[name])
            if e >= err[f"flash_attention {name}"]:
                err[f"flash_attention {name}"], worst[name] = e, label
            n_flash += 1
    print(f"shuffle vs plain on the card: {n_shuffle} cases (5 ops x "
          f"{len(SHUFFLE_HALVES)} halves x amounts 0/32/-5/2N+3 x N "
          f"2/64/128/256 x float32/bfloat16/int32), all bitwise; RoPE vs "
          f"plain: {n_rope} cases (both layouts x dh 18/32/120/128 x base "
          f"offset 0/1 x theta 1e4/1e6 x float32/bfloat16 x positions "
          f"int32 a row, int64 per 3 rows, float32 per 5 rows, int32 per "
          f"16 rows, < 8192), max |diff| "
          f"float32 {err['rope float32']:.3e} bfloat16 "
          f"{err['rope bfloat16']:.3e} (tol {ROPE_TOL}, x max|plain|); "
          f"flash vs plain: {n_flash} cases (GQA, MQA, windows, Sq != Skv "
          f"without causal, S % 64 != 0, Sq 1, off-band tiles, 32 heads, "
          f"dh 18-256, scores to ~+-30, 32768 keys a row), max |diff| "
          f"float32 {err['flash_attention float32']:.3e} (at "
          f"{worst['float32']}) "
          f"bfloat16 {err['flash_attention bfloat16']:.3e} (at "
          f"{worst['bfloat16']}) (tol (atol, rtol) {FLASH_TOL})")
    return err


def standalone_path(audio, dev, card: str) -> dict:
    """Phase S: the shuffle, RoPE and flash-attention entries at the full
    widths of their users, each run with the launch counts set to 0 just
    before it and read just after, every output held against the plain
    version. Returns what phase 5 times, {case: dict}, and the launches
    of every run, {kernel: {entry: n}}."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import FLASH_TOL
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rope.kernel import rope_plain
    from repro_torch.kernels.rope.ops import rope
    from repro_torch.kernels.shuffle.kernel import OPS, shuffle_plain
    from repro_torch.kernels.shuffle.ops import shuffle
    from repro_torch.serve.stream import frame_signal

    cases, totals = {}, {}

    def tally(got: dict) -> None:
        for kernel in ("shuffle", "rope", "flash_attention"):
            for entry, n in got[kernel].items():
                totals.setdefault(kernel, {}).setdefault(entry, 0)
                totals[kernel][entry] += n

    # S1: each ASR frame of the hour as A = its first and B = its second
    # 256 samples, so bit_reverse is the 512-point FFT's reorder
    frames = frame_signal(audio, ASR_WINDOW, ASR_HOP)
    a1 = frames[:, : ASR_WINDOW // 2].contiguous()
    b1 = frames[:, ASR_WINDOW // 2:].contiguous()
    del frames
    # S2: the paper's VWR of 128 32-bit words, a million rows
    g = torch.Generator(device=dev).manual_seed(21)
    a2, b2 = (torch.randint(-2 ** 31, 2 ** 31 - 1, (VWR_ROWS, VWR_WORDS),
                            generator=g, device=dev, dtype=torch.int32)
              for _ in range(2))
    for tag, a, b, runs in (
            ("S1", a1, b1, [(op, "both") for op in OPS] +
             [(op, h) for op in ("interleave", "bit_reverse",
                                 "circular_shift")
              for h in ("lower", "upper")]),
            ("S2", a2, b2, [(op, "both") for op in OPS])):
        outs, got = counted(lambda: [shuffle(a, b, op, half=h, amount=32)
                                     for op, h in runs])
        want = {}
        for op, h in runs:
            want[("shuffle", op)] = want.get(("shuffle", op), 0) + 1
        expect_launches(f"shuffle {tag}", got, want)
        tally(got)
        for (op, h), out in zip(runs, outs):
            check_bitwise(f"shuffle {tag} {op} {h}", out,
                          shuffle_plain(a, b, op, half=h, amount=32))
            cases[f"shuffle {tag} {op} {h}"] = {
                "kernel": "shuffle", "entry": op, "label": f"{tag} {h}",
                "edge": "shuffle",
                "launches": got["shuffle"][op], "max_abs_err": 0.0,
                "args": (a, b, op, h)}
        del outs
        print(f"shuffle {tag} ({a.shape[0]} x {a.shape[1]} {a.dtype}): "
              f"{len(runs)} entry calls (" +
              ", ".join(f"{o}/{h}" for o, h in runs) +
              f"), launches {got['shuffle']}, all bitwise equal to plain "
              f"[{card}]")
    # R1: qwen1.5-0.5b prefill q (B 4, S 2048, H 16, dh 64), theta 1e6;
    # R2: h2o-danube3-4b q (1, 8192, 32, 120), theta 1e4, bfloat16
    for tag, shape, theta, named in ROPE_PATH:
        runs = [(lay, getattr(torch, dt)) for lay, dt in named]
        B, S, H, dh = shape
        x32 = torch.randn(shape, generator=g, device=dev)
        # one int32 position per (batch row, slot), shared by the H heads
        pos = torch.arange(S, device=dev, dtype=torch.int32).repeat(B, 1)
        xs = {dt: x32.to(dt) for _, dt in runs}
        outs, got = counted(lambda: [rope(xs[dt], pos, theta=theta,
                                          layout=lay) for lay, dt in runs])
        want = {}
        for lay, _ in runs:
            want[("rope", lay)] = want.get(("rope", lay), 0) + 1
        expect_launches(f"rope {tag}", got, want)
        tally(got)
        for (lay, dt), out in zip(runs, outs):
            name = str(dt).replace("torch.", "")
            x2 = xs[dt].reshape(-1, dh)
            want = rope_plain(x2, pos.reshape(-1), theta=theta, layout=lay,
                              heads=H)
            err = check_scaled(f"rope {tag} {lay} {name}",
                               out.reshape(-1, dh), want, ROPE_TOL[name])
            cases[f"rope {tag} {lay} {name}"] = {
                "kernel": "rope", "entry": lay, "label": f"{tag} {name}",
                "edge": f"rope {name}",
                "launches": got["rope"][lay],
                "max_abs_err": err, "theta": theta,
                "args": (xs[dt], pos)}
            if tag == "R1":
                wrong = wrong_slot_reading(x2, pos.reshape(-1), want,
                                           theta=theta, layout=lay, heads=H)
                if not wrong > ROPE_TOL[name]:
                    raise AssertionError(
                        f"rope {tag} {lay} {name}: slot s + 1's table on "
                        f"slot s reads {wrong:.3e} <= tol {ROPE_TOL[name]}: "
                        f"the check would not see it")
                cases[f"rope {tag} {lay} {name}"]["wrong_slot"] = wrong
            del want
        del outs
        print(f"rope {tag} (x {shape}, positions arange({S}) per batch row,"
              f" theta {theta:g}): {len(runs)} entry calls, launches "
              f"{got['rope']}, max |diff| vs plain "
              + ", ".join(f"{c['entry']} "
                          f"{c['max_abs_err']:.3e}" for k, c in cases.items()
                          if k.startswith(f"rope {tag}"))
              + f" (tol {ROPE_TOL} x max|plain|)"
              + ("; slot s + 1's table on slot s (rope_wrong_slot) would "
                 "read max |diff| / max |plain| " + ", ".join(
                     f"{c['entry']} {c['wrong_slot']:.3e}"
                     for k, c in cases.items()
                     if k.startswith(f"rope {tag}")) + ", flagged"
                 if tag == "R1" else "") + f" [{card}]")
    # F1: qwen1.5-0.5b prefill; F2: h2o-danube3-4b at its 4096 window;
    # F3: whisper-medium encoder self-attention over 1,500 frames
    for tag, (B, S, H, KV, dh), causal, window, chunk, dtypes in FLASH_PATH:
        for name in dtypes:
            dt = getattr(torch, name)
            q = torch.randn(B, S, H, dh, generator=g, device=dev).to(dt)
            k = torch.randn(B, S, KV, dh, generator=g, device=dev).to(dt)
            v = torch.randn(B, S, KV, dh, generator=g, device=dev).to(dt)
            out, got = counted(lambda: flash_attention(
                q, k, v, causal=causal, window=window, q_chunk=chunk,
                kv_chunk=chunk))
            expect_launches(f"flash {tag} {name}", got,
                            {("flash_attention", "attention"): 1})
            tally(got)
            want = plain_attention_by_group(q, k, v, causal=causal,
                                            window=window)
            err = check_elementwise(f"flash {tag} {name}", out, want,
                                    FLASH_TOL[name])
            drop_err, drop_flagged = dropped_tile_reading(
                q, k, v, want, causal=causal, window=window,
                tol=FLASH_TOL[name])
            if drop_flagged == 0.0:
                raise AssertionError(
                    f"flash {tag} {name}: the tolerance {FLASH_TOL[name]} "
                    f"would not see a dropped {FLASH_DROP_TILE}-key tile "
                    f"(max |diff| {drop_err:.3e})")
            one = None
            if name == "float32":
                one = one_product_reading(q, k, v, want, causal=causal,
                                          window=window, tol=FLASH_TOL[name])
                if one[1] == 0.0:
                    raise AssertionError(
                        f"flash {tag} {name}: the tolerance "
                        f"{FLASH_TOL[name]} would not see one TF32 product "
                        f"in place of three (max |diff| {one[0]:.3e})")
            del want
            cases[f"flash {tag} {name}"] = {
                "kernel": "flash_attention", "entry": "attention",
                "label": f"{tag} {name}", "edge": f"flash_attention {name}",
                "launches": got["flash_attention"]["attention"],
                "max_abs_err": err, "args": (q, k, v, causal, window),
                "dropped_tile": (drop_err, drop_flagged)}
            if one is not None:
                cases[f"flash {tag} {name}"]["one_product"] = one
            print(f"flash {tag} {name} (B {B}, S {S}, H {H}, KV {KV}, dh "
                  f"{dh}, causal {causal}, window {window}, chunks {chunk}):"
                  f" 1 launch, max |diff| vs plain {err:.3e} over every "
                  f"element (tol (atol, rtol) {FLASH_TOL[name]}); a dropped "
                  f"{FLASH_DROP_TILE}-key tile would read max |diff| "
                  f"{drop_err:.3e} and fail at {100 * drop_flagged:.1f}% of "
                  f"kv head 0's outputs"
                  + (f"; one TF32 product in place of three would read max "
                     f"|diff| {one[0]:.3e} and fail at {100 * one[1]:.1f}%"
                     if one is not None else "") + f" [{card}]")
    return cases, totals


def standalone_times(cases: dict, edge_err: dict, card: str) -> list:
    """Phase 5 rows 7-9: device time of each phase-S case beside its bound,
    the plain version's time and, for attention and the shuffle, one
    PyTorch call (`scaled_dot_product_attention` with ``enable_gqa``, a
    boolean band mask for a window; `shuffle_library`, held bitwise to the
    kernel's output), timed here only; returns the JSON entries."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.rope.kernel import rope_plain
    from repro_torch.kernels.rope.ops import rope
    from repro_torch.kernels.shuffle.kernel import (shuffle_cuda,
                                                    shuffle_plain)

    kernels = []
    for key, c in cases.items():
        lib_ms, lib_name = None, None
        if c["kernel"] == "shuffle":
            a, b, op, h = c["args"]
            out_n = a.shape[1] if (h != "both" or op.startswith("prune")) \
                else 2 * a.shape[1]
            ms = event_ms(lambda: shuffle_cuda(a, b, op, half=h), 20)
            pms = event_ms(lambda: shuffle_plain(a, b, op, half=h), 3)
            lfn = shuffle_library(a, b, op, h, 32)
            if lfn is not None:
                # the same function: bitwise the kernel's output
                check_bitwise(f"library {key}", lfn(),
                              shuffle_cuda(a, b, op, half=h))
                lib_ms = event_ms(lfn, 20)
                lib_name = ("torch.stack" if op == "interleave" else
                            "torch.cat") + ", bitwise the kernel's output"
            bms, by = bound_ms(*shuffle_work(a.shape[0], out_n,
                                             a.element_size()))
            src, rep = SHUFFLE_SOURCE, SHUFFLE_REPLACES
        elif c["kernel"] == "rope":
            # the entry on the card is the one launch: it reads the (B, S)
            # positions itself, one per slot
            x, pos = c["args"]
            lay, theta = c["entry"], c["theta"]
            H, dh = x.shape[-2:]
            ms = event_ms(lambda: rope(x, pos, theta=theta, layout=lay), 20)
            pms = event_ms(lambda: rope_plain(
                x.reshape(-1, dh), pos.reshape(-1), theta=theta, layout=lay,
                heads=H), 3)
            bms, by = bound_ms(*rope_work(x.numel() // dh, pos.numel(), dh,
                                          x.element_size(),
                                          pos.element_size()))
            src, rep = ROPE_SOURCE, ROPE_REPLACES
        else:
            q, k, v, causal, window = c["args"]
            B, S, H, dh = q.shape
            KV = k.shape[2]
            ms = event_ms(lambda: flash_attention_cuda(
                q, k, v, causal=causal, window=window), 5)
            pms = event_ms(lambda: plain_attention_by_group(
                q, k, v, causal=causal, window=window), 2)
            work = flash_work(B, S, S, H, KV, dh, q.element_size(), causal,
                              window)
            if q.dtype == torch.bfloat16:
                bms, by = bound_ms(*work, PEAK_BF16)
                peak_name = "at the 989 TFLOP/s bf16 tensor peak"
            else:
                # the least of two routes: the 4 dh operations a pair on
                # the CUDA cores, or three TF32 products on the tensor cores
                routes = {"CUDA cores": bound_ms(*work, PEAK_FP32),
                          "3xTF32": bound_ms(work[0], 3 * work[1],
                                             PEAK_TF32)}
                bms, by = min(routes.values())
                peak_name = ("the least of 3xTF32 (3 x operations at 495 "
                             f"TFLOP/s) {routes['3xTF32'][0]:.5f} ms and the "
                             f"67 TFLOP/s CUDA cores "
                             f"{routes['CUDA cores'][0]:.5f} ms")
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            mask = None
            if window is not None:
                i = torch.arange(S, device=q.device)[:, None]
                j = torch.arange(S, device=q.device)[None, :]
                mask = (i - j < window) & ((i >= j) if causal else True)

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=True)

            lib_ms = event_ms(sdpa, 3)
            lib_err = float((sdpa().transpose(1, 2).float() -
                             flash_attention_cuda(q, k, v, causal=causal,
                                                  window=window).float())
                            .abs().max())
            lib_name = (f"scaled_dot_product_attention, max |diff| vs the "
                        f"kernel {lib_err:.3e}; bound {peak_name}")
            # what the redesign is judged on: the rate over the 4 dh
            # operations per live pair, the share of the bound, the ratio
            # to one PyTorch call
            judged = {"tflops": work[1] / ms / 1e9, "bound_share": bms / ms,
                      "vs_library": ms / lib_ms}
            lib_name += (f"; {judged['tflops']:.1f} TFLOP/s over 4 dh per "
                         f"live pair, {100 * judged['bound_share']:.1f}% of "
                         f"the bound, {judged['vs_library']:.2f}x the "
                         f"library's time")
            src, rep = FLASH_SOURCE, FLASH_REPLACES
        entry = {"name": f"{c['kernel']}[{c['entry']}] {c['label']}",
                 "route": "cuda", "source": src, "replaces": rep,
                 "launches": c["launches"],
                 "max_abs_err": max(c["max_abs_err"], edge_err[c["edge"]]),
                 "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                 "library_ms": lib_ms}
        if c["kernel"] == "flash_attention":
            entry.update(judged)
            if q.dtype == torch.float32:
                entry.update({f"bound_{r.replace(' ', '_').lower()}_ms":
                              t for r, (t, _) in routes.items()})
        kernels.append(entry)
        print(f"time {key}: kernel {ms:.4f} ms, plain {pms:.3f} ms, "
              + (f"library {lib_ms:.4f} ms ({lib_name}), "
                 if lib_ms is not None else "")
              + f"bound {bms:.5f} ms ({by}) [{card}]")
    return kernels


# phase C: the column paths over the day (4 columns, batch_windows 8)
COLUMNS, COLUMN_WEIGHTS, KILL_DISPATCH = 4, (1, 1, 2, 4), 169
TRANSIENTS = {(2, 100), (2, 101)}       # (column, dispatch) pairs
FAULT_BOUND = 1.5       # the reference's --check-fault bound on the ratio


class GcPauses:
    """Log the interpreter's garbage-collection pauses as (generation, ms)
    while the ``with`` block runs."""

    def __init__(self):
        self.log, self._t = [], None

    def _callback(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.log.append((info["generation"],
                             (time.perf_counter() - self._t) * 1e3))
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)


def logged_dispatches(runner) -> list:
    """Wrap ``runner._dispatch`` to log (column, start, count, outcome,
    wall ms) of every dispatch it attempts."""
    log, inner = [], runner._dispatch

    def dispatch(column, sig, start, count):
        t = time.perf_counter()
        try:
            out = inner(column, sig, start, count)
        except Exception as e:
            log.append((column, start, count, type(e).__name__,
                        (time.perf_counter() - t) * 1e3))
            raise
        log.append((column, start, count, "ok",
                    (time.perf_counter() - t) * 1e3))
        return out

    runner._dispatch = dispatch
    return log


def column_paths(app, sig, day_ref: dict, n: int, card: str,
                 runners: bool = True) -> dict:
    """Phase C: the multi-column deal and (with ``runners``) the
    fault-tolerant runner over the day, each run bitwise equal to phase
    3's single-column output (``day_ref``, all four outputs) with its
    launch count checked; returns launches, walls and the runners'
    per-column busy seconds."""
    import torch

    from repro_torch.kernels.pipeline.kernel import OUTPUTS
    from repro_torch.kernels.pipeline.shard import (pipeline_sharded,
                                                    pipeline_stream_sharded)
    from repro_torch.serve.fault import FaultInjector, \
        FaultTolerantColumnRunner
    from repro_torch.serve.resident import ResidentConfig
    from repro_torch.serve.stream import (BiosignalStream, StreamConfig,
                                          column_mesh, frame_signal)

    D, B = COLUMNS, 8
    dispatches = -(-n // (B * D))
    res = {"launches": {}, "host_ms": {}, "busy": {}, "dispatches": {},
           "dispatch_log": {}, "gc_ms": {}, "warm_ms": {}}

    def timed(tag, fn, want):
        t = time.perf_counter()
        out, got = counted(fn)
        wall = (time.perf_counter() - t) * 1e3
        expect_launches(tag, got, want)
        check_equal(tag, out, {k: day_ref[k] for k in out})
        if sorted(out) != sorted(OUTPUTS):
            raise AssertionError(f"{tag}: outputs {sorted(out)}")
        res["launches"][tag] = sum(v for e in got.values()
                                   for v in e.values())
        res["host_ms"][tag] = wall
        return out

    # the column mesh: serial columns, then every column on a CUDA stream
    # of its own on this card, then (on a host with D cards) each on its
    # own card, as the reference's shard_map puts column d on device d
    cards = column_mesh(D)
    if torch.cuda.device_count() < D:
        if cards is not None:
            raise AssertionError(f"column_mesh({D}) = {cards} on "
                                 f"{torch.cuda.device_count()} cards")
    elif cards is None or len(set(cards)) != D:
        raise AssertionError(f"column_mesh({D}) = {cards}")
    meshes = [("", None), (" mesh=streams", (sig.device,) * D)] + (
        [(" mesh=cards", cards)] if cards is not None else [])
    stream_tags = ("stream n_columns=4", "stream n_columns=4 host-framed",
                   f"stream n_columns=4 weights={COLUMN_WEIGHTS}")
    for label, mesh in meshes:
        if mesh is not None:     # each device's module loaded, its streams
            pipeline_stream_sharded(    # made, before any timing
                sig[: (D - 1) * HOP + WINDOW], app.fir_taps, app.svm_w,
                app.svm_b, window=WINDOW, hop=HOP, n_columns=D, mesh=mesh)
        # the entries: one launch per column over the whole day; the first
        # call of each checked, then the median of five more, synchronised
        frames = frame_signal(sig, WINDOW, HOP)
        entries = {
            "pipeline_stream_sharded": (lambda: pipeline_stream_sharded(
                sig, app.fir_taps, app.svm_w, app.svm_b, window=WINDOW,
                hop=HOP, n_columns=D, mesh=mesh), "stream"),
            "pipeline_sharded": (lambda: pipeline_sharded(
                frames, app.fir_taps, app.svm_w, app.svm_b, n_columns=D,
                mesh=mesh), "frames")}
        for base, (fn, entry) in entries.items():
            timed(base + label, fn, {("biosignal_graph", entry): D})
            walls = []
            for _ in range(5):
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1e3)
            res["warm_ms"][base + label] = sorted(walls)[2]
        del frames, entries
        # the stream, dealt: every dispatch's 32 frames (the tail's padded)
        # give each column a non-zero share, one launch each
        for base, kw, entry in zip(stream_tags, (
                {}, {"framing": "host"},
                {"column_weights": COLUMN_WEIGHTS}),
                ("stream", "frames", "stream")):
            tag = base + label
            cfg = StreamConfig(window=WINDOW, hop=HOP, batch_windows=B,
                               n_columns=D, **kw)
            stream = BiosignalStream(app, cfg)
            if stream.mesh != cards:
                raise AssertionError(f"{tag}: stream mesh {stream.mesh}")
            stream.mesh = mesh
            timed(tag, lambda: stream.process(sig),
                  {("biosignal_graph", entry): dispatches * D})
            res["dispatches"][tag] = dispatches
            print(f"column deal {tag}: bitwise equal to the single-column "
                  f"stream, {dispatches} dispatches x {D} launches, "
                  f"{res['host_ms'][tag]:.1f} ms wall, "
                  f"{res['host_ms'][tag] / dispatches:.4f} ms a dispatch "
                  f"[{card}]")
    res["mesh_ms_a_dispatch"] = {
        base: {(label.strip() or "serial"):
               res["host_ms"][base + label] / dispatches
               for label, _ in meshes}
        for base in stream_tags}
    res["mesh_ms_a_dispatch"].update({
        base: {(label.strip() or "serial"): res["host_ms"][base + label]
               for label, _ in meshes}
        for base in ("pipeline_stream_sharded", "pipeline_sharded")})
    print(f"column mesh: column_mesh({D}) = "
          + (f"{[str(d) for d in cards]}" if cards is not None else
             f"None ({torch.cuda.device_count()} card(s))")
          + "; host ms a dispatch, serial / "
          + " / ".join(label.strip() for label, _ in meshes[1:]) + ": "
          + "; ".join(f"{base} " + " / ".join(
              f"{v:.4f}" for v in row.values())
              for base, row in res["mesh_ms_a_dispatch"].items())
          + f" (the entries: one dispatch over the day) [{card}]")
    print("column mesh, the entries warm (the median of five synchronised "
          "calls after the first), host ms serial / "
          + " / ".join(label.strip() for label, _ in meshes[1:]) + ": "
          + "; ".join(f"{base} " + " / ".join(
              f"{res['warm_ms'][base + label]:.4f}" for label, _ in meshes)
              for base in ("pipeline_stream_sharded", "pipeline_sharded"))
          + f" [{card}]")
    if cards is not None:
        # what a column off the input's card pays alone: its outputs' copy
        # back to card 0, against the cards' warm entry above
        peer = all(torch.cuda.can_device_access_peer(a.index, b.index)
                   for a in cards for b in cards if a != b)
        rows = -(-n // D)
        far = {k: v[:rows].to(cards[1]) for k, v in day_ref.items()}
        nbytes = sum(v.numel() * v.element_size() for v in far.values())
        walls = []
        for _ in range(6):
            t = time.perf_counter()
            back = {k: v.to(sig.device) for k, v in far.items()}
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            del back
        res["copy_back_ms"] = sorted(walls[1:])[2]
        res["peer_access"] = peer
        print(f"column mesh over cards: peer access between every pair "
              f"{peer}; one column's outputs ({nbytes / 1e6:.1f} MB) card 1 "
              f"-> card 0 alone {res['copy_back_ms']:.4f} ms (the median "
              f"of five synchronised copies after the first) [{card}]")
        del far
    if not runners:
        return res
    # the fault-tolerant runner: fault-free (before and after the others:
    # host time drifts), a kill, two transients, a resident kill
    cfg = StreamConfig(window=WINDOW, hop=HOP, batch_windows=B)
    runs = [("runner batch", "batch", {}, "stream", B),
            ("runner batch kill", "batch",
             {"kill": {1: KILL_DISPATCH}}, "stream", B),
            ("runner batch transients", "batch",
             {"transient": TRANSIENTS}, "stream", B),
            ("runner batch again", "batch", {}, "stream", B),
            ("runner resident kill", "resident",
             {"kill_drain": {3: 1}}, "ring", 4 * B)]
    for tag, mode, faults, entry, per_launch in runs:
        runner = FaultTolerantColumnRunner(
            app, cfg, n_columns=D, mode=mode,
            rcfg=ResidentConfig(ring_depth=4, drain_interval=1),
            injector=FaultInjector(**faults), devices=[sig.device] * D)
        log = logged_dispatches(runner)
        t = time.perf_counter()
        with GcPauses() as gcp:
            out, got = counted(lambda: runner.process(sig))
        res["host_ms"][tag] = (time.perf_counter() - t) * 1e3
        pauses = gcp.log
        # a dispatch killed at on_dispatch launched nothing; one killed at
        # a drain ran its whole loop first
        want = sum(-(-c // per_launch) for _, _, c, how, _ in log
                   if how == "ok" or mode == "resident")
        expect_launches(tag, got, {("biosignal_graph", entry): want})
        check_equal(tag, out, {k: day_ref[k] for k in out})
        if "kill" in tag and runner.requeues < 1:
            raise AssertionError(f"{tag}: no requeue after the kill")
        if "transient" in tag and runner.scheduler.dead:
            raise AssertionError(f"{tag}: a transient killed "
                                 f"{runner.scheduler.dead}")
        res["launches"][tag] = want
        res["dispatches"][tag] = runner.dispatches
        res["busy"][tag] = list(runner.column_busy)
        print(f"{tag}: bitwise equal to the single-column stream, "
              f"{runner.dispatches} dispatches ({len(log)} attempted), "
              f"requeues {runner.requeues}, dead "
              f"{sorted(runner.scheduler.dead)}, {want} {entry} launches; "
              f"column_busy ms "
              + ", ".join(f"{b * 1e3:.1f}" for b in runner.column_busy)
              + f" (max {max(runner.column_busy) * 1e3:.1f}); "
              f"{res['host_ms'][tag]:.1f} ms wall, "
              f"{res['host_ms'][tag] / runner.dispatches:.4f} ms a "
              f"dispatch [{card}]")
        slow = sorted(log, key=lambda e: -e[4])[:3]
        big = [e for e in log if e[2] > B and mode == "batch"]
        print(f"{tag}: slowest dispatches (column, start, count, outcome, "
              f"ms) {[(c, s0, k, h, round(ms, 3)) for c, s0, k, h, ms in slow]}"
              + (f"; requeued runs {[(c, k, round(ms, 3)) for c, _, k, _, ms in big]}"
                 if big else "")
              + f"; gc pauses {len(pauses)}, "
              f"{sum(ms for _, ms in pauses):.1f} ms in all, the longest "
              + (f"{max(pauses, key=lambda e: e[1])[1]:.1f} ms (generation "
                 f"{max(pauses, key=lambda e: e[1])[0]})" if pauses
                 else "none"))
        res["gc_ms"][tag] = list(pauses)
        res["dispatch_log"][tag] = log
        del out
    kill = max(res["busy"]["runner batch kill"])
    res["kill_ratio"] = [kill / max(res["busy"][tag]) for tag in
                         ("runner batch", "runner batch again")]
    print(f"fault recovery: max(column_busy) kill / fault-free = "
          + " and ".join(f"{r:.3f}" for r in res["kill_ratio"])
          + f" (fault-free before / after; the reference's bound "
          f"{FAULT_BOUND}x; host time, printed only) [{card}]")
    return res


# phase L: LM serving at qwen1.5-0.5b's full width (random weights)
LM_ARCH = "qwen1.5-0.5b"
LM_PARAM_SEED, LM_DATA_SEED = 0, 1
# Relative L2 error of one step's logits, ||got - want|| / ||want|| over
# its (rows, vocab) float32 logits. Both sides compute in bfloat16 with
# float32 accumulation but sum in different orders (another GEMM shape,
# another device), so a layer output near a bfloat16 rounding boundary
# rounds apart (2^-9 relative) and that spreads to the logits. On the CPU
# at 4-12 full-width layers (`tools/lm_tolerance.py`) prefill + decode
# read 0.006-0.010 against forward and bfloat16 0.012-0.016 against
# float32 compute; a decode whose rope angle is one position late read
# 0.25-0.33. 0.03 sits twice above the whole bfloat16 rounding error and
# ~8x under the late angle.
LM_TOL = 0.03
LM_BATCH, LM_PROMPT_LEN, LM_FORCED = 4, (64, 300), 8
LM_CPU_PROMPT, LM_CPU_STEPS = 64, 4
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_MAX_NEW = 4, 1024, 8, 32
LM_SERVE_PROMPT = (16, 480)
LM_WIDE_SLOTS = 16                  # the slots-16 decode timing, 16 requests
LM_TEMPERATURE, LM_SAMPLE_SEED = 0.8, 7


def rel_err(got, want) -> float:
    """||got - want|| / ||want|| in float32 (the LM gates' measure)."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def memory_line(tag: str) -> str:
    import torch

    return (f"{tag}: max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


def weight_counts(cparams) -> tuple:
    """(the layers' attention and MLP weights, the bytes one decode step
    reads of all weights) of cast parameters."""
    from repro_torch.models.layers import tree_items

    layer_params = sum(t.numel() for p, t in tree_items(cparams)
                       if p[0] == "stack" and p[-2] in ("attn", "mlp"))
    weight_bytes = sum(t.numel() * t.element_size()
                       for p, t in tree_items(cparams))
    return layer_params, weight_bytes


def lm_prompts(n: int, lo: int, hi: int, vocab: int, seed: int) -> list:
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(rng.integers(lo, hi + 1))).tolist()
            for _ in range(n)]


def wrong_rope_decode(model, params, batch, cache):
    """What phase L's check reads from a decode whose rotary angle is one
    position late (q and k rotated at cache_len + 1; everything else
    as the model): the run fails unless `LM_TOL` flags it."""
    from repro_torch.models import attention as att

    right = att.apply_rope
    att.apply_rope = lambda x, pos, **kw: right(x, pos + 1, **kw)
    try:
        return model.decode(params, batch, cache)
    finally:
        att.apply_rope = right


def make_timed_engine(base=None, keep_steps: bool = False):
    """An engine of class ``base`` (default `Engine`) whose dispatch hooks
    time each prefill (per bucket) and decode with CUDA events and keep
    each request's first-step logits (and, with ``keep_steps``, every
    decode's logits of each request, ``steps[rid]``); a paged engine's
    decode also keeps its block table."""
    import torch

    from repro_torch.serve.engine import Engine

    class TimedEngine(base or Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.prefills, self.decodes, self.first = [], [], {}
            self.steps: dict = {}

        def _prefill_dispatch(self, batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
            out = super()._prefill_dispatch(batch)
            e1.record()
            torch.cuda.synchronize()
            self.prefills.append({
                "width": int(batch["tokens"].shape[1]),
                "tokens": int((batch["tokens"] != 0).sum()),
                "ms": e0.elapsed_time(e1),
                "wall_ms": (time.perf_counter() - t) * 1e3})
            return out

        def _decode_dispatch(self, batch):
            if getattr(self, "table", None) is not None:
                self.last_bt = torch.as_tensor(self.table.block_table(
                    [r.rid if r is not None else None for r in self.live]),
                    device=self.device)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
            logits, cache = super()._decode_dispatch(batch)
            e1.record()
            self.decodes.append((e0, e1, self.lens.copy(),
                                 [r is not None for r in self.live]))
            for s, r in enumerate(self.live):
                if r is not None and not r.out:
                    self.first[r.rid] = logits[s, 0].clone()
                if r is not None and keep_steps:
                    self.steps.setdefault(r.rid, []).append(
                        logits[s, 0].clone())
            self.last_batch = batch
            return logits, cache

    return TimedEngine


def serve_run(engine_cls, model, params, prompts, *, slots, dev,
              temperature=0.0, order=None, max_len=None, max_new=None,
              tag="phase L", prepare=None, on_step=None, **engine_kw):
    """Serve ``prompts`` (rid = index) through a fresh engine; returns
    ({rid: tokens}, the engine, host wall per step, whether each step
    admitted, and the wall of the whole run). ``prepare(eng)`` runs once
    the requests are queued, ``on_step(eng, done)`` after every step."""
    import torch

    from repro_torch.serve.engine import Request

    max_len = LM_MAX_LEN if max_len is None else max_len
    max_new = LM_MAX_NEW if max_new is None else max_new
    eng = engine_cls(model, params, slots=slots, max_len=max_len,
                     temperature=temperature, seed=LM_SAMPLE_SEED,
                     device=dev, **engine_kw)
    for rid in (order if order is not None else range(len(prompts))):
        eng.add_request(Request(rid, list(prompts[rid]), max_new=max_new))
    if prepare is not None:
        prepare(eng)
    torch.cuda.synchronize()
    walls, admits, done = [], [], []
    t0 = time.perf_counter()
    while eng._work_pending():
        queued = len(eng.queue)
        t = time.perf_counter()
        done += eng.step()          # ends in a host read of the tokens
        walls.append(time.perf_counter() - t)
        admits.append(len(eng.queue) < queued)
        if on_step is not None:
            on_step(eng, done)
    wall = time.perf_counter() - t0
    if sorted(r.rid for r in done) != list(range(len(prompts))):
        raise AssertionError(f"{tag}: the engine lost requests")
    bad = [r.rid for r in done if len(r.out) != max_new]
    if bad:
        raise AssertionError(f"{tag}: requests {bad} finished short of "
                             f"max_new {max_new}")
    return {r.rid: tuple(r.out) for r in done}, eng, walls, admits, wall


def lm_path(dev, card: str, cfg=None) -> dict:
    """Phase L: `build_model` / `init_model_params` / `Engine` at
    qwen1.5-0.5b's full width on the card (``cfg`` cuts it for a
    rehearsal). Gates cache against forward, card against CPU (and the
    late rope angle against the tolerance), and the server's repeats;
    prints the times beside their bounds."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import (build_model, cast_params, init_cache,
                                    init_model_params)
    from repro_torch.models.layers import param_count, tree_map
    from repro_torch.serve.engine import Engine

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    res: dict = {}
    cfg = cfg or get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    # ---- L1: build and load
    model = build_model(cfg, device=dev)
    params = init_model_params(model, LM_PARAM_SEED, device=dev)
    cparams = cast_params(model, params)
    n_params = param_count(model.schema)
    layer_params, weight_bytes = weight_counts(cparams)
    res["params"] = n_params
    print(f"L1 {cfg.name}: {n_params:,} parameters ({cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads, dh {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}); float32 {n_params * 4 / 1e9:.3f} GB, "
          f"{layer_params:,} layer weights cast once to bfloat16; one "
          f"decode step reads {weight_bytes / 1e9:.3f} GB of weights; "
          + memory_line("after load"))

    # ---- L2: cache against forward, 4 prompts, 8 teacher-forced steps
    prompts = lm_prompts(LM_BATCH, *LM_PROMPT_LEN, cfg.vocab_size,
                         LM_DATA_SEED)
    forced = lm_prompts(LM_BATCH, LM_FORCED, LM_FORCED, cfg.vocab_size,
                        LM_DATA_SEED + 1)
    lens = np.array([len(p) for p in prompts])
    toks = np.zeros((LM_BATCH, lens.max() + LM_FORCED), np.int64)
    for b in range(LM_BATCH):
        seq = prompts[b] + forced[b]
        toks[b, :len(seq)] = seq
    toks_t = torch.as_tensor(toks, device=dev)
    with torch.no_grad():
        full, _ = model.forward(cparams, {"tokens": toks_t})
        cache = init_cache(model, LM_BATCH, LM_MAX_LEN, device=dev)
        last, cache = model.prefill(
            cparams, {"tokens": toks_t[:, :lens.max()] * torch.as_tensor(
                np.arange(lens.max())[None, :] < lens[:, None],
                device=dev)}, cache)
        errs = [rel_err(last[lens.argmax(), 0],
                        full[lens.argmax(), lens.max() - 1])]
        agree = 0
        for t in range(LM_FORCED):
            tok = torch.as_tensor([[f[t]] for f in forced], device=dev)
            cl = torch.as_tensor(lens + t, device=dev)
            got, cache = model.decode(cparams, {"tokens": tok,
                                                "cache_len": cl}, cache)
            want = full[torch.arange(LM_BATCH), torch.as_tensor(
                lens + t, device=dev)]
            errs.append(rel_err(got[:, 0], want))
            agree += int((got[:, 0].argmax(-1) == want.argmax(-1)).sum())
    del full
    res["cache_vs_forward"] = errs
    print(f"L2 cache vs forward: prompts of {lens.tolist()} tokens, prefill "
          f"then {LM_FORCED} teacher-forced decode steps; relative error "
          f"{min(errs):.5f}-{max(errs):.5f} (tol {LM_TOL}); argmax agrees "
          f"on {agree}/{LM_BATCH * LM_FORCED} [{card}]; "
          + memory_line("after L2"))
    if max(errs) > LM_TOL:
        raise AssertionError(f"phase L2: cache vs forward {max(errs):.5f} "
                             f"> {LM_TOL}")

    # ---- L3: card against CPU, and the late rope angle
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = cast_params(cpu_model, tree_map(lambda t: t.cpu(), params))
    one = torch.as_tensor([prompts[0][:LM_CPU_PROMPT]])
    steps = [[forced[0][t]] for t in range(LM_CPU_STEPS)]
    outs = {}
    with torch.no_grad():
        for tag, m, p, d in (("cpu", cpu_model, cpu_params, "cpu"),
                             ("card", model, cparams, dev),
                             ("late rope", model, cparams, dev)):
            c = init_cache(m, 1, LM_MAX_LEN, device=d)
            lg, c = m.prefill(p, {"tokens": one.to(d)}, c)
            seq = [lg[:, 0].cpu()]
            for t in range(LM_CPU_STEPS):
                b = {"tokens": torch.as_tensor([steps[t]], device=d),
                     "cache_len": torch.as_tensor([LM_CPU_PROMPT + t],
                                                  device=d)}
                if tag == "late rope":
                    lg, c = wrong_rope_decode(m, p, b, c)
                else:
                    lg, c = m.decode(p, b, c)
                seq.append(lg[:, 0].cpu())
            outs[tag] = seq
    card_err = [rel_err(a, b) for a, b in zip(outs["card"], outs["cpu"])]
    wrong = [rel_err(a, b) for a, b in zip(outs["late rope"][1:],
                                           outs["cpu"][1:])]
    res.update(card_vs_cpu=card_err, late_rope=wrong)
    print(f"L3 card vs CPU: one {LM_CPU_PROMPT}-token prompt, prefill + "
          f"{LM_CPU_STEPS} teacher-forced steps; relative error "
          f"{min(card_err):.5f}-{max(card_err):.5f} (tol {LM_TOL}); a decode "
          f"with the rope angle one position late reads "
          f"{min(wrong):.5f}-{max(wrong):.5f} [{card}]; "
          + memory_line("after L3"))
    if max(card_err) > LM_TOL:
        raise AssertionError(f"phase L3: card vs CPU {max(card_err):.5f} > "
                             f"{LM_TOL}")
    if min(wrong) <= LM_TOL:
        raise AssertionError(f"phase L3: the tolerance {LM_TOL} does not "
                             f"flag a late rope angle ({min(wrong):.5f})")
    del cpu_model, cpu_params, outs

    # ---- L4: the server, 8 requests at slots 4, greedy then sampled
    TimedEngine = make_timed_engine()
    reqs = lm_prompts(LM_REQUESTS, *LM_SERVE_PROMPT, cfg.vocab_size,
                      LM_DATA_SEED + 2)
    with torch.no_grad():
        greedy, _, _, _, _ = serve_run(Engine, model, params, reqs,
                                       slots=LM_SLOTS, dev=dev)
        timed, teng, walls, admits, _ = serve_run(
            TimedEngine, model, params, reqs, slots=LM_SLOTS, dev=dev)
        again, _, _, _, e2e = serve_run(Engine, model, params, reqs,
                                        slots=LM_SLOTS, dev=dev)
        samp = [serve_run(Engine, model, params, reqs, slots=LM_SLOTS,
                          dev=dev, temperature=LM_TEMPERATURE)[0]
                for _ in range(2)]
    if not greedy == timed == again:
        raise AssertionError("phase L4: repeated greedy runs differ")
    if samp[0] != samp[1]:
        raise AssertionError("phase L4: repeated sampled runs differ")
    if samp[0] == greedy:
        raise AssertionError("phase L4: temperature 0.8 gave the greedy "
                             "tokens")
    # each request's first token against its prompt prefilled alone
    first_err, ties = [], []
    with torch.no_grad():
        for rid, prompt in enumerate(reqs):
            c = init_cache(model, 1, LM_MAX_LEN, device=dev)
            lg, _ = model.prefill(cparams, {"tokens": torch.as_tensor(
                [prompt], device=dev)}, c)
            want, got = lg[0, 0], teng.first[rid]
            first_err.append(rel_err(got, want))
            top = torch.topk(want, 2).values
            gap = float(top[0] - top[1])
            if int(want.argmax()) != greedy[rid][0]:
                if gap > 2 * float((got - want).abs().max()):
                    raise AssertionError(
                        f"phase L4: request {rid}'s first token "
                        f"{greedy[rid][0]} != {int(want.argmax())} (gap "
                        f"{gap:.4f})")
                ties.append(rid)
    res["first_token"] = {"rel_err": first_err, "near_ties": ties}
    if max(first_err) > LM_TOL:
        raise AssertionError(f"phase L4: first-step logits "
                             f"{max(first_err):.5f} > {LM_TOL} against the "
                             f"prompt alone")
    res["tokens"] = {str(k): v for k, v in greedy.items()}
    print(f"L4 server: Engine(slots={LM_SLOTS}, max_len={LM_MAX_LEN}) served "
          f"{LM_REQUESTS} requests of {min(map(len, reqs))}-"
          f"{max(map(len, reqs))} prompt tokens, max_new {LM_MAX_NEW}, "
          f"greedy three times and at temperature {LM_TEMPERATURE} (seed "
          f"{LM_SAMPLE_SEED}) twice: every request finished, repeats "
          f"identical; first-step logits vs each prompt alone "
          f"{max(first_err):.5f} (tol {LM_TOL}), first tokens equal"
          + (f" but near ties {ties}" if ties else "") + "; "
          + memory_line("after L4"))
    # placement (printed, not gated)
    with torch.no_grad():
        place = {
            "slots=1": serve_run(Engine, model, params, reqs, slots=1,
                                 dev=dev)[0],
            "slots=2": serve_run(Engine, model, params, reqs, slots=2,
                                 dev=dev)[0],
            "reversed order": serve_run(
                Engine, model, params, reqs, slots=LM_SLOTS, dev=dev,
                order=list(range(LM_REQUESTS))[::-1])[0]}
    res["placement"] = {k: sorted(r for r in v if v[r] != greedy[r])
                        for k, v in place.items()}
    print("L4 placement (printed, not gated): requests whose greedy tokens "
          "differ from slots 4 in order: " + "; ".join(
              f"{k} {v or 'none'}" for k, v in res["placement"].items()))

    # ---- L5: times beside their bounds
    from repro_torch.analysis.roofline import prefill_work

    res["prefill"] = []
    for p in teng.prefills:
        nbytes, ops = prefill_work(cfg, weight_bytes, layer_params,
                                   LM_SLOTS, p["width"])
        bms, by = bound_ms(nbytes, ops, PEAK_BF16)
        p.update(bound_ms=bms, bound_by=by)
        res["prefill"].append(p)
    by_width: dict = {}
    for p in res["prefill"]:
        by_width.setdefault(p["width"], []).append(p)
    busy = {}
    with torch.no_grad():
        for w in by_width:
            pad = torch.ones((LM_SLOTS, w), dtype=torch.int64, device=dev)
            busy[w] = device_busy(lambda: model.prefill(
                cparams, {"tokens": pad}, teng.cache))
    res["prefill_busy"] = busy
    print("L5 prefill per bucket (slots x width rows; CUDA-event span of "
          "the dispatch; the card's busy time and launches of one call, "
          "profiler): " + "; ".join(
              f"{w}: {len(ps)} call(s), {min(p['ms'] for p in ps):.3f} ms, "
              f"{LM_SLOTS * w / min(p['ms'] for p in ps) * 1e3:,.0f} rows/s "
              f"({max(p['tokens'] for p in ps) / min(p['ms'] for p in ps) * 1e3:,.0f}"
              f" prompt tokens/s), busy {busy[w][0]:.3f} ms over "
              f"{busy[w][1]} launches, bound {ps[0]['bound_ms']:.4f} ms "
              f"({ps[0]['bound_by']})" for w, ps in sorted(by_width.items()))
          + f" [{card}]")
    res["decode"] = {LM_SLOTS: decode_times(teng, walls, admits, cfg,
                                            weight_bytes, layer_params,
                                            model, card)}
    res["e2e_tok_s"] = LM_REQUESTS * LM_MAX_NEW / e2e
    print(f"L5 end to end: {LM_REQUESTS * LM_MAX_NEW} tokens in {e2e:.3f} s,"
          f" {res['e2e_tok_s']:.1f} generated tokens/s at slots {LM_SLOTS} "
          f"[{card}]")
    wide = lm_prompts(LM_WIDE_SLOTS, *LM_SERVE_PROMPT, cfg.vocab_size,
                      LM_DATA_SEED + 3)
    with torch.no_grad():
        _, weng, wwalls, wadmits, _ = serve_run(
            TimedEngine, model, params, wide, slots=LM_WIDE_SLOTS, dev=dev)
        _, _, _, _, we2e = serve_run(Engine, model, params, wide,
                                     slots=LM_WIDE_SLOTS, dev=dev)
    res["decode"][LM_WIDE_SLOTS] = decode_times(
        weng, wwalls, wadmits, cfg, weight_bytes, layer_params, model, card)
    res["e2e_tok_s_wide"] = LM_WIDE_SLOTS * LM_MAX_NEW / we2e
    print(f"L5 end to end: {LM_WIDE_SLOTS * LM_MAX_NEW} tokens in "
          f"{we2e:.3f} s, {res['e2e_tok_s_wide']:.1f} generated tokens/s at "
          f"slots {LM_WIDE_SLOTS} [{card}]; " + memory_line("after L5"))
    return res


def decode_times(eng, walls, admits, cfg, weight_bytes, layer_params, model,
                 card, tag="L5", busy_call=None, work=None) -> dict:
    """Decode ms per engine step of ``eng``'s run: CUDA-event span of each
    decode dispatch and host wall of each step without admission (medians
    of the warm steps, the first two left out), the card's busy time and
    launches of one decode (``busy_call``, default the model's decode on
    the engine's cache), and the bound of the median step (``work(n_rows,
    contexts)`` gives its bytes and operations; default `decode_work`)."""
    import numpy as np
    import torch

    from repro_torch.analysis.roofline import decode_work

    torch.cuda.synchronize()
    steps = [(e0.elapsed_time(e1), lens, live)
             for e0, e1, lens, live in eng.decodes]
    warm = [i for i in range(2, len(steps)) if not admits[i]]
    ev = float(np.median([steps[i][0] for i in warm]))
    host = float(np.median([walls[i] * 1e3 for i in warm]))
    mid = warm[len(warm) // 2]
    _, lens, live = steps[mid]
    contexts = [int(n) for n, a in zip(lens, live) if a]
    nbytes, ops = (work(eng.slots, contexts) if work is not None else
                   decode_work(cfg, weight_bytes, layer_params, eng.slots,
                               contexts))
    bms, by = bound_ms(nbytes, ops, PEAK_BF16)
    batch = eng.last_batch
    busy, launches = device_busy(busy_call or (
        lambda: model.decode(eng.params, batch, eng.cache)))
    out = {"event_ms": ev, "host_ms": host, "device_busy_ms": busy,
           "launches": launches, "idle_share": 1 - busy / host,
           "bound_ms": bms, "bound_by": by, "bytes": nbytes,
           "warm_steps": len(warm), "contexts": contexts}
    print(f"{tag} decode at slots {eng.slots}: {ev:.3f} ms a step (CUDA-event "
          f"median of {len(warm)} warm steps), {host:.3f} ms host wall a "
          f"step; one decode keeps the card busy {busy:.3f} ms over "
          f"{launches} launches (profiler), idle {out['idle_share']:.1%} "
          f"of the step; bound {bms:.4f} ms ({by}: {nbytes / 1e9:.3f} GB "
          f"over {len(contexts)} live contexts) [{card}]")
    return out


def device_busy(fn) -> tuple:
    """(device-busy ms, kernel launches) of one warm call of ``fn``: the
    summed durations of the CUDA kernels and copies of a `torch.profiler`
    trace. `event_ms`'s device sleep cannot time a call of a thousand
    launches or more: the launch queue fills before the sleep ends and
    the card then waits on the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in kern) / 1e3, len(kern)


# phase P: paged KV, the supervised engines and the unified front-end
PAGE_SIZE = 16
# the reference bench's oversubscribed mix (benchmarks/table5_app.py):
# requests, prompt tokens, max_new, max_len; slots LM_SLOTS
P_OVERSUB = (14, 2, 12, 256)
P_KILL = {0: 4}              # slot 0 dies at its fourth decode dispatch
P_TRANSIENT = {(1, 3)}       # one transient on slot 1's third decode
WHISPER_ARCH = "whisper-medium"
# Relative L2 error of whisper's logits, card against CPU (the measure of
# `LM_TOL`). `tools/lm_tolerance.py --arch whisper-medium` on the CPU at
# full width, vocab cut to 32,768, 2 / 4 / 8 / 12 / 24 encoder and
# decoder layers, one 8-token prompt over 1,500 frames: bfloat16 against
# float32 compute 0.0057 / 0.0066 / 0.0083 / 0.0094 / 0.0126, prefill +
# decode against forward at most 0.011; a decode whose sinusoidal
# position is one late 0.125 / 0.088 / 0.075 / 0.055 / 0.038 (falling
# with depth, so printed, not gated); the same decode with the cache's
# encoder K/V zeroed (a prefill that stored none) 0.43 / 0.57 / 0.65 /
# 0.69 / 0.77. 0.03 sits 2.4x above the whole bfloat16 rounding error at
# 24 layers and 25x under the lost encoder K/V, which the run must flag.
WHISPER_TOL = 0.03
WHISPER_PROMPT, WHISPER_STEPS, WHISPER_MAX_LEN = 8, 2, 448
P_LM = (4, 3, 8, 8)          # LM requests: count, prompt 3-8 tokens, max_new
P_ASR_SECONDS, P_ASR_MAX_NEW, P_ASR_TICKETS = 30, 8, 3
P_QOS = {"lm": 2, "stream": 1, "asr": 1}
P_COLUMNS = 4


def token_agreement(a: dict, b: dict) -> float:
    """The share of token positions where runs ``a`` and ``b`` agree."""
    same = sum(x == y for r in a for x, y in zip(a[r], b[r]))
    return same / sum(len(a[r]) for r in a)


def same_steps(a, b) -> bool:
    """Did timed engines ``a`` and ``b`` give every request bitwise the
    same logits at every decode?"""
    import torch

    return a.steps.keys() == b.steps.keys() and all(
        len(a.steps[r]) == len(b.steps[r]) and all(
            torch.equal(x, y) for x, y in zip(a.steps[r], b.steps[r]))
        for r in a.steps)


def diverge(a, b) -> int:
    """The index of the first token where sequences ``a`` and ``b``
    differ (their length if none does)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def paged_path(dev, card: str, cfg=None) -> dict:
    """Phase P1: `PagedEngine` against the dense `Engine` at qwen1.5-0.5b's
    full width (``cfg`` cuts it for a rehearsal) on phase L's 8 requests
    and on the oversubscribed mix. Gates completion, freed pages,
    ``peak_admitted``, each request's decode logits within `LM_TOL` of
    dense up to its first greedy token that differs, repeats and a
    mid-decode defrag bitwise; prints token agreement and one decode
    step's times beside dense's."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, cast_params, init_model_params
    from repro_torch.serve.engine import Engine, PagedEngine
    from repro_torch.serve.paged import paged_decode

    res: dict = {}
    cfg = cfg or get_config(LM_ARCH)
    model = build_model(cfg, device=dev)
    params = init_model_params(model, LM_PARAM_SEED, device=dev)
    layer_params, weight_bytes = weight_counts(cast_params(model, params))
    reqs = lm_prompts(LM_REQUESTS, *LM_SERVE_PROMPT, cfg.vocab_size,
                      LM_DATA_SEED + 2)
    TimedDense = make_timed_engine(Engine, keep_steps=True)
    TimedPaged = make_timed_engine(PagedEngine, keep_steps=True)
    run = dict(model=model, params=params, prompts=reqs, slots=LM_SLOTS,
               dev=dev, tag="phase P1")
    moves = []

    def defrag_each_step(eng, done):
        if done:
            moves.append(eng.defrag())

    def freed(eng, tag):
        if eng.pool.n_free != eng.pool.capacity:
            raise AssertionError(f"phase P1 {tag}: {eng.pool.n_free} pages "
                                 f"free of {eng.pool.capacity}")

    with torch.no_grad():
        dense, deng, dwalls, dadmits, _ = serve_run(TimedDense, **run)
        paged, peng, pwalls, padmits, _ = serve_run(
            TimedPaged, page_size=PAGE_SIZE, **run)
        again, aeng, _, _, _ = serve_run(TimedPaged, page_size=PAGE_SIZE,
                                         **run)
        moved, meng, _, _, _ = serve_run(TimedPaged, page_size=PAGE_SIZE,
                                         on_step=defrag_each_step, **run)
        dsamp = serve_run(Engine, temperature=LM_TEMPERATURE, **run)[0]
        psamp, seng, _, _, _ = serve_run(PagedEngine, page_size=PAGE_SIZE,
                                         temperature=LM_TEMPERATURE, **run)
        n, plen, max_new, max_len = P_OVERSUB
        short = lm_prompts(n, plen, plen, cfg.vocab_size, LM_DATA_SEED + 4)
        over = dict(run, prompts=short, max_new=max_new, max_len=max_len)
        odense = serve_run(Engine, **over)[0]
        opaged, oeng, _, _, _ = serve_run(PagedEngine, page_size=PAGE_SIZE,
                                          **over)
    for tag, eng in (("greedy", peng), ("repeat", aeng), ("defrag", meng),
                     ("sampled", seng), ("oversubscribed", oeng)):
        freed(eng, tag)
    if oeng.peak_admitted != n:
        raise AssertionError(f"phase P1: peak_admitted {oeng.peak_admitted} "
                             f"on the oversubscribed mix, expected {n}")
    if again != paged or not same_steps(aeng, peng):
        raise AssertionError("phase P1: a repeated paged run differs")
    n_moves = sum(len(m) for m in moves)
    if not n_moves:
        raise AssertionError("phase P1: the defrag run moved no page")
    if moved != paged or not same_steps(meng, peng):
        raise AssertionError("phase P1: decoding through a defrag differs "
                             "from the paged run")
    first = [rel_err(peng.first[r], deng.first[r]) for r in range(len(reqs))]
    # each request's decodes against dense up to and including its first
    # greedy token that differs: until then both fed the same tokens, and
    # every step past the first reads rows that decode wrote to the pool
    steps = {r: [rel_err(p, d) for p, d in zip(
        peng.steps[r][: diverge(paged[r], dense[r]) + 1], deng.steps[r])]
        for r in range(len(reqs))}
    worst = max(max(e) for e in steps.values())
    if worst > LM_TOL:
        raise AssertionError(f"phase P1: decode logits paged vs dense "
                             f"{worst:.5f} > {LM_TOL} before the tokens "
                             f"part")
    n_steps = sum(len(e) for e in steps.values())
    res.update(first_vs_dense=first, steps_vs_dense=steps,
               defrag_moves=n_moves,
               peak_admitted={"serve": peng.peak_admitted,
                              "oversubscribed": oeng.peak_admitted},
               agreement={"greedy": token_agreement(paged, dense),
                          "sampled": token_agreement(psamp, dsamp),
                          "oversubscribed": token_agreement(opaged, odense)})
    print(f"P1 paged: PagedEngine(slots={LM_SLOTS}, max_len={LM_MAX_LEN}, "
          f"page_size={PAGE_SIZE}) against Engine on phase L's "
          f"{LM_REQUESTS} requests (max_new {LM_MAX_NEW}): every request "
          f"finished, every page freed, peak_admitted "
          f"{peng.peak_admitted}; first-step logits vs dense "
          f"{min(first):.5f}-{max(first):.5f}, all {n_steps} decodes up to "
          f"each request's first differing token at most {worst:.5f} (tol "
          f"{LM_TOL}); token "
          f"agreement with dense {res['agreement']['greedy']:.3f} greedy, "
          f"{res['agreement']['sampled']:.3f} at temperature "
          f"{LM_TEMPERATURE}; a repeated run and one through {n_moves} "
          f"defrag moves bitwise (every decode's logits) [{card}]")
    print(f"P1 oversubscribed: {n} requests of {plen} prompt tokens, max_new "
          f"{max_new}, slots {LM_SLOTS}, max_len {max_len}: peak_admitted "
          f"{oeng.peak_admitted} (the dense engine holds {LM_SLOTS}), token "
          f"agreement with dense {res['agreement']['oversubscribed']:.3f}")
    res["decode"] = {
        "dense": decode_times(deng, dwalls, dadmits, cfg, weight_bytes,
                              layer_params, model, card, tag="P1 dense"),
        "paged": decode_times(
            peng, pwalls, padmits, cfg, weight_bytes, layer_params, model,
            card, tag="P1 paged", busy_call=lambda: paged_decode(
                model.decode, peng.pool.paths, peng.pool.specs,
                peng.params, peng.last_batch, peng.pool.leaves,
                peng.last_bt))}
    res["reqs"], res["sampled"] = reqs, {"dense": dsamp, "paged": psamp}
    print(memory_line("P1 done"))
    return res, model, params


def supervised_path(model, params, reqs, sampled, dev, card: str) -> dict:
    """Phase P2: `FaultTolerantEngine` and `FaultTolerantPagedEngine` on
    phase L's requests at temperature 0.8, fault-free, with slot 0 killed
    (`P_KILL`) and with one transient (`P_TRANSIENT`). Gates completion,
    the fault-free tokens bitwise the unsupervised engine's of P1
    (``sampled``), one eviction and one replay, the tokens before the
    kill bitwise, the transient absorbed bitwise; prints the agreement
    after the kill and the recovered to fault-free wall ratio."""
    import torch

    from repro_torch.serve.engine_fault import (FaultInjector,
                                                FaultTolerantEngine,
                                                FaultTolerantPagedEngine)

    res: dict = {}
    run = dict(model=model, params=params, prompts=reqs, slots=LM_SLOTS,
               dev=dev, temperature=LM_TEMPERATURE, tag="phase P2")
    for name, cls, kw in (("dense", FaultTolerantEngine, {}),
                          ("paged", FaultTolerantPagedEngine,
                           {"page_size": PAGE_SIZE})):
        at_kill: dict = {}

        def snapshot_at_eviction(eng):
            reqs_all = list(eng.queue)
            real = eng._evict

            def evict(s):
                at_kill.update({r.rid: tuple(r.out) for r in reqs_all})
                real(s)
            eng._evict = evict

        with torch.no_grad():
            free, feng, _, _, fwall = serve_run(
                cls, injector=FaultInjector(), **run, **kw)
            killed, keng, _, _, kwall = serve_run(
                cls, injector=FaultInjector(kill=dict(P_KILL)),
                prepare=snapshot_at_eviction, **run, **kw)
            trans, teng, _, _, _ = serve_run(
                cls, injector=FaultInjector(transient=set(P_TRANSIENT)),
                **run, **kw)
        if (keng.evictions, keng.replays) != (1, 1):
            raise AssertionError(f"phase P2 {name}: evictions "
                                 f"{keng.evictions}, replays {keng.replays}")
        if free != sampled[name]:
            raise AssertionError(f"phase P2 {name}: fault-free supervised "
                                 f"tokens differ from the plain engine's")
        if feng.evictions or teng.evictions or teng.dead_slots:
            raise AssertionError(f"phase P2 {name}: a fault-free or "
                                 f"transient run evicted")
        before = {r: out for r, out in at_kill.items()
                  if killed[r][:len(out)] != out or free[r][:len(out)] != out}
        if not at_kill or before:
            raise AssertionError(f"phase P2 {name}: tokens before the kill "
                                 f"differ for requests {sorted(before)}")
        if trans != free:
            raise AssertionError(f"phase P2 {name}: the transient run's "
                                 f"tokens differ from the fault-free run's")
        if name == "paged" and keng.pool.n_free != keng.pool.capacity:
            raise AssertionError("phase P2 paged: pages leaked after the kill")
        n_before = sum(len(v) for v in at_kill.values())
        res[name] = {"agreement_after_kill": token_agreement(killed, free),
                     "tokens_before_kill": n_before,
                     "wall_ratio": kwall / fwall, "wall_s": [fwall, kwall],
                     "decode_steps": [feng.decode_steps, keng.decode_steps],
                     "prefill_dispatches": [feng.prefill_dispatches,
                                            keng.prefill_dispatches]}
        print(f"P2 {cls.__name__}: {LM_REQUESTS} requests at temperature "
              f"{LM_TEMPERATURE}, every one completed fault-free, with slot "
              f"0 killed at dispatch {P_KILL[0]} (evictions 1, replays 1; "
              f"{n_before} tokens before the kill bitwise the fault-free "
              f"run's; token agreement after it "
              f"{res[name]['agreement_after_kill']:.3f}) and with a "
              f"transient at {sorted(P_TRANSIENT)} (absorbed in place, "
              f"tokens bitwise); recovered / fault-free wall "
              f"{res[name]['wall_ratio']:.3f} ({kwall:.3f} / {fwall:.3f} s; "
              f"the reference gates 1.5x; host-bound, printed only) [{card}]")
    return res


def round_robin(classes: list, qos: dict) -> list:
    """The submission indices in the order weighted round-robin over
    ``qos`` dispatches arrivals of ``classes``, nothing refused."""
    pending = list(enumerate(classes))
    order = []
    while pending:
        for cls, weight in qos.items():
            for _ in range(weight):
                item = next((p for p in pending if p[1] == cls), None)
                if item is None:
                    break
                order.append(item[0])
                pending.remove(item)
    return order


def asr_launches_per_ticket(front) -> dict:
    """Wrap ``front``'s ASR dispatch so that each attempt adds the ASR
    graph launches it made to its ticket's rid; returns {rid: [launches
    of each attempt]}, filled as the front-end runs."""
    from repro_torch.kernels import _cuda

    seen: dict = {}
    real = front._dispatch_asr

    def dispatch(ticket, work, kwargs):
        n0 = _cuda.LAUNCHES["asr_graph"]["stream"]
        try:
            real(ticket, work, kwargs)
        finally:
            seen.setdefault(work.rid, []).append(
                _cuda.LAUNCHES["asr_graph"]["stream"] - n0)
    front._dispatch_asr = dispatch
    return seen


def whisper_vs_cpu(model, params, card: str) -> dict:
    """Whisper's logits on the card against the same parameters on the
    CPU: one `WHISPER_PROMPT`-token prompt prefilled over the encoder
    output of ``enc_ctx`` frames from a seed, then `WHISPER_STEPS`
    decodes; and what the check reads from the card's decode with the
    cache's encoder K/V zeroed (gated above `WHISPER_TOL`) or with the
    sinusoidal position one late (printed)."""
    import torch

    from repro_torch.models import (api, build_model, cast_params,
                                    init_cache)
    from repro_torch.models.layers import tree_map

    cfg = model.cfg
    g = torch.Generator().manual_seed(LM_DATA_SEED + 5)
    frames = torch.randn((1, cfg.enc_ctx, cfg.d_model), generator=g)
    toks = torch.randint(1, cfg.vocab_size,
                         (1, WHISPER_PROMPT + WHISPER_STEPS), generator=g)
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = cast_params(cpu_model, tree_map(lambda t: t.cpu(), params))
    dev = next(iter(params["embed"].values())).device
    cparams = cast_params(model, params)
    table = api.L.sinusoidal_positions
    outs, secs = {}, {}
    with torch.no_grad():
        for tag, m, p, d in (("cpu", cpu_model, cpu_params, "cpu"),
                             ("card", model, cparams, dev),
                             ("no encoder K/V", model, cparams, dev),
                             ("late position", model, cparams, dev)):
            t0 = time.perf_counter()
            c = init_cache(m, 1, WHISPER_MAX_LEN, device=d)
            lg, c = m.prefill(p, {"tokens": toks[:, :WHISPER_PROMPT].to(d),
                                  "frames": frames.to(d)}, c)
            seq = [lg[:, 0].float().cpu()]
            if tag == "no encoder K/V":
                for leaf in ("ek", "ev"):
                    c["seg0"]["l0_cross"][leaf].zero_()
            for t in range(WHISPER_STEPS):
                n = WHISPER_PROMPT + t
                b = {"tokens": toks[:, n:n + 1].to(d),
                     "cache_len": torch.as_tensor([n], device=d)}
                if tag == "late position":
                    api.L.sinusoidal_positions = \
                        lambda s, dd, dt, dv: table(s, dd, dt, dv)[1:]
                try:
                    lg, c = m.decode(p, b, c)
                finally:
                    api.L.sinusoidal_positions = table
                seq.append(lg[:, 0].float().cpu())
            outs[tag], secs[tag] = seq, time.perf_counter() - t0
    err = [rel_err(a, b) for a, b in zip(outs["card"], outs["cpu"])]
    blind = [rel_err(a, b) for a, b in zip(outs["no encoder K/V"][1:],
                                           outs["cpu"][1:])]
    late = [rel_err(a, b) for a, b in zip(outs["late position"][1:],
                                          outs["cpu"][1:])]
    print(f"P3 whisper card vs CPU: one {WHISPER_PROMPT}-token prompt over "
          f"{cfg.enc_ctx} frames from a seed, prefill + {WHISPER_STEPS} "
          f"decodes; relative error {min(err):.5f}-{max(err):.5f} (tol "
          f"{WHISPER_TOL}); the decode with the encoder K/V zeroed reads "
          f"{min(blind):.5f}-{max(blind):.5f}, with the position one late "
          f"{min(late):.5f}-{max(late):.5f} (printed); CPU "
          f"{secs['cpu']:.1f} s, card {secs['card']:.2f} s [{card}]")
    if max(err) > WHISPER_TOL:
        raise AssertionError(f"phase P3: whisper card vs CPU {max(err):.5f} "
                             f"> {WHISPER_TOL}")
    if min(blind) <= WHISPER_TOL:
        raise AssertionError(f"phase P3: the tolerance {WHISPER_TOL} does "
                             f"not flag lost encoder K/V ({min(blind):.5f})")
    return {"card_vs_cpu": err, "no_encoder_kv": blind,
            "late_position": late, "seconds": secs}


def frontend_path(dev, card: str, bio_app, cfg=None) -> dict:
    """Phase P3: `ServeFrontend` over whisper-medium at full width (``cfg``
    cuts it for a rehearsal) on a `FaultTolerantEngine(slots=4)` and a
    `ColumnScheduler` over `P_COLUMNS` columns of the one card: LM
    requests, two `StreamOpen`s and `P_ASR_TICKETS` `AsrTranscribe`s of
    30 s of synthetic audio under `P_QOS`. Gates one ASR graph launch a
    ticket, features bitwise a direct entry call and within
    `ASR_LOGMEL_TOL` of the plain version, the round-robin order,
    ``max_queue=1`` backpressure without a second launch, column lending
    and return, and whisper's logits against the CPU."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.biosignal import synthetic_respiration
    from repro_torch.kernels.pipeline.graph import (default_app,
                                                    get_graph_factory,
                                                    graph_stream_plain)
    from repro_torch.kernels.pipeline.ops import graph_pipeline_stream
    from repro_torch.models import build_model, init_model_params
    from repro_torch.serve.engine import ColumnScheduler, Request
    from repro_torch.serve.engine_fault import FaultTolerantEngine
    from repro_torch.serve.frontend import (AsrTranscribe, ServeFrontend,
                                            StreamOpen)
    from repro_torch.serve.stream import StreamConfig

    res: dict = {}
    cfg = cfg or get_config(WHISPER_ARCH)
    model = build_model(cfg, device=dev)
    params = init_model_params(model, LM_PARAM_SEED, device=dev)
    res["logits"] = whisper_vs_cpu(model, params, card)
    rng = np.random.default_rng(LM_DATA_SEED + 6)
    n_lm, lo, hi, lm_new = P_LM
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(lo, hi + 1)))
               .tolist() for _ in range(n_lm)]
    audio = [synthetic_audio(P_ASR_SECONDS * ASR_RATE, seed=10 + i,
                             device=dev)
             for i in range(P_ASR_TICKETS)]
    works = ([Request(i, prompts[i], max_new=lm_new) for i in range(n_lm)]
             + [StreamOpen(f"sensor-{i}", bio_app,
                           StreamConfig(window=WINDOW, hop=HOP))
                for i in range(2)]
             + [AsrTranscribe(100 + i, audio[i], max_new=P_ASR_MAX_NEW)
                for i in range(P_ASR_TICKETS)])
    classes = ["lm"] * n_lm + ["stream"] * 2 + ["asr"] * P_ASR_TICKETS
    ids = list(range(n_lm)) + ["sensor-0", "sensor-1"] + \
        [100 + i for i in range(P_ASR_TICKETS)]

    def engine(**kw):
        return FaultTolerantEngine(model, params, slots=LM_SLOTS,
                                   max_len=WHISPER_MAX_LEN, device=dev, **kw)

    eng = engine()
    sched = ColumnScheduler(devices=[dev] * P_COLUMNS)
    front = ServeFrontend(engine=eng, scheduler=sched, qos=P_QOS)
    order = []
    add, place = eng.add_request, sched.place_stream
    eng.add_request = lambda req, **kw: (order.append(req.rid),
                                         add(req, **kw))[1]
    sched.place_stream = lambda app=None, cfg=None, *, stream_id: (
        order.append(stream_id), place(app, cfg, stream_id=stream_id))[1]
    tickets = [front.submit(w) for w in works]
    per_ticket = asr_launches_per_ticket(front)
    t0 = time.perf_counter()
    with torch.no_grad():
        _, launches = counted(front.run)
    wall = time.perf_counter() - t0
    expect_launches("phase P3 front-end", launches,
                    {("asr_graph", "stream"): P_ASR_TICKETS})
    if sorted(per_ticket) != ids[-P_ASR_TICKETS:] or \
            any(sum(v) != 1 for v in per_ticket.values()):
        raise AssertionError(f"phase P3: ASR graph launches per ticket "
                             f"{per_ticket}, expected one each")
    if [t.status for t in tickets] != ["done"] * len(tickets):
        raise AssertionError(f"phase P3: tickets "
                             f"{[t.status for t in tickets]}")
    want = [ids[i] for i in round_robin(classes, P_QOS)]
    if order != want:
        raise AssertionError(f"phase P3: dispatch order {order}, the "
                             f"policy gives {want}")
    graph, ops = get_graph_factory("asr")(default_app("asr", device=dev))
    errs = []
    for i, t in enumerate(tickets[-P_ASR_TICKETS:]):
        got = t.result().features
        direct = graph_pipeline_stream("asr", None, audio[i], window=ASR_WINDOW,
                                       hop=ASR_HOP, outputs=("logmel",))
        if not torch.equal(got, direct["logmel"]):
            raise AssertionError(f"phase P3: ticket {t.tid}'s features differ "
                                 f"from a direct graph_pipeline_stream call")
        plain = graph_stream_plain(audio[i], ops, graph=graph,
                                   window=ASR_WINDOW, hop=ASR_HOP,
                                   outputs=("logmel",))
        errs.append(check_asr(f"phase P3 ticket {t.tid}", {"logmel": got},
                              plain))
    n_frames = tuple(tickets[-1].result().features.shape)
    streams = [t.result() for t in tickets[n_lm:n_lm + 2]]
    # one whisper decode at the engine's slots, as L5 reads qwen's
    step = {"tokens": torch.ones((LM_SLOTS, 1), dtype=torch.int64,
                                 device=dev),
            "cache_len": torch.full((LM_SLOTS,), WHISPER_PROMPT,
                                    device=dev)}
    with torch.no_grad():
        wbusy, wlaunches = device_busy(
            lambda: eng._decode(eng.params, step, eng.cache))
        whost = host_ms(lambda: eng._decode(eng.params, step, eng.cache), 5)
    res["decode"] = {"device_busy_ms": wbusy, "launches": wlaunches,
                     "host_ms": whost}
    res.update(launches=launches, order=order, max_abs_err=max(errs),
               wall_s=wall, features=n_frames,
               tokens={str(i): t.result().out for i, t in
                       zip(ids, tickets[:n_lm])} |
               {str(i): t.result().tokens for i, t in
                zip(ids[-P_ASR_TICKETS:], tickets[-P_ASR_TICKETS:])})
    print(f"P3 front-end: ServeFrontend(qos={P_QOS}) over whisper-medium "
          f"({cfg.num_layers} + {cfg.encoder_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, enc_ctx {cfg.enc_ctx}) on "
          f"FaultTolerantEngine(slots={LM_SLOTS}, max_len={WHISPER_MAX_LEN}) "
          f"and {P_COLUMNS} columns: {n_lm} LM requests, 2 StreamOpens, "
          f"{P_ASR_TICKETS} AsrTranscribes of {P_ASR_SECONDS} s "
          f"({n_frames[0]} frames x {n_frames[1]} mels each) all done in "
          f"{wall:.2f} s (one whisper decode at slots {LM_SLOTS}: "
          f"{whost:.1f} ms of host, the card busy {wbusy:.2f} ms over "
          f"{wlaunches} launches); dispatch order {order} is the "
          f"policy's; asr_graph "
          f"launched {launches['asr_graph']['stream']} times (stream entry, "
          f"one a ticket), features bitwise a direct call, within "
          f"{max(errs):.2e} of the plain version [{card}]")

    # backpressure: max_queue 1 refuses all but one ticket a pump
    eng2 = engine(max_queue=1)
    front2 = ServeFrontend(engine=eng2)
    per_ticket2 = asr_launches_per_ticket(front2)
    t2 = [front2.submit(AsrTranscribe(200 + i, audio[i], max_new=2))
          for i in range(P_ASR_TICKETS)]
    with torch.no_grad():
        _, launches2 = counted(front2.run)
    expect_launches("phase P3 backpressure", launches2,
                    {("asr_graph", "stream"): P_ASR_TICKETS})
    attempts = sum(len(v) for v in per_ticket2.values())
    if [t.status for t in t2] != ["done"] * P_ASR_TICKETS or \
            attempts <= P_ASR_TICKETS or \
            any(v[0] != 1 or sum(v) != 1 for v in per_ticket2.values()):
        raise AssertionError(f"phase P3 backpressure: "
                             f"{[t.status for t in t2]}, launches per "
                             f"attempt {per_ticket2}")
    for a, b in zip(t2, tickets[-P_ASR_TICKETS:]):
        if not torch.equal(a.result().features, b.result().features):
            raise AssertionError("phase P3 backpressure: features differ")
    res["backpressure_launches"] = per_ticket2
    print(f"P3 backpressure: max_queue=1, {P_ASR_TICKETS} AsrTranscribes "
          f"dispatched in {attempts} attempts, asr_graph launched "
          f"{launches2['asr_graph']['stream']} times, once at each ticket's "
          f"first attempt ({per_ticket2}: the stash reused on every "
          f"retry), features bitwise the first front-end's")

    # column lending: lend 1 (a free column), then 3 (one stream re-pins)
    sig = synthetic_respiration(1, 64 * HOP + WINDOW, seed=4,
                                device=dev)[0][0]
    before = [s.process(sig) for s in streams]
    lent = []
    for n in (1, 3):
        front.lend_columns(n)
        moves = sched.pop_moves()
        for s in streams:
            if s.stream_id in moves:
                s.repin(moves[s.stream_id],
                        column=sched.column_of(s.stream_id))
        if any(s.column in sched.dead for s in streams):
            raise AssertionError("phase P3: a stream stayed on a lent column")
        after = [s.process(sig) for s in streams]
        for a, b in zip(after, before):
            if any(not torch.equal(a[k], b[k]) for k in b):
                raise AssertionError("phase P3: a re-pinned stream's "
                                     "output differs")
        restored = front.return_columns()
        lent.append({"lent": n, "moves": sorted(moves),
                     "healthy_while_lent": P_COLUMNS - n,
                     "restored": restored})
        if sched.healthy_columns() != list(range(P_COLUMNS)):
            raise AssertionError(f"phase P3: columns after return "
                                 f"{sched.healthy_columns()}")
    if not lent[1]["moves"]:
        raise AssertionError("phase P3: lending 3 columns re-pinned no "
                             "stream")
    res["lending"] = lent
    print(f"P3 columns: lend_columns(1) moved {lent[0]['moves'] or 'no'} "
          f"stream(s), lend_columns(3) re-pinned {lent[1]['moves']}; each "
          f"stream's output bitwise before and after, return_columns "
          f"restored {lent[0]['restored']} and {lent[1]['restored']}; "
          + memory_line("after P3"))
    return res


def phase_p(dev, card: str, bio_app, lm_cfg=None, whisper_cfg=None) -> dict:
    """Phase P: P1 and P2 with the launch counts set to 0 just before and
    read just after (the paged and supervised engines launch no kernel of
    the port), then P3."""
    import torch

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    (p1, model, params), launches = counted(
        lambda: paged_path(dev, card, lm_cfg))
    p2, launches2 = counted(lambda: supervised_path(
        model, params, p1.pop("reqs"), p1.pop("sampled"), dev, card))
    for tag, got in (("P1", launches), ("P2", launches2)):
        if any(n for entries in got.values() for n in entries.values()):
            raise AssertionError(f"phase {tag} launched a kernel: {got}")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    p3 = frontend_path(dev, card, bio_app, whisper_cfg)
    secs = time.perf_counter() - t0
    print(f"phase P: {secs:.1f} s; P1 and P2 launched no kernel of the "
          f"port, P3's ASR tickets the ASR graph only; peak "
          + memory_line("phase P"))
    return {"paged": p1, "supervised": p2, "frontend": p3, "seconds": secs,
            "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30}


# phase M: the other model families at full width and depth (random
# weights)
M_ARCHS = ("deepseek-moe-16b", "rwkv6-7b", "zamba2-7b", "qwen2-vl-2b")
M_PARAM_SEED, M_DATA_SEED = 0, 11
# the depth of the card-against-CPU check: deepseek's dense first layer
# and one MoE layer; zamba2's first pattern (five Mamba2 layers, then one
# with the shared attention block)
M_CPU_LAYERS = {"deepseek-moe-16b": 2, "rwkv6-7b": 2, "zamba2-7b": 6,
                "qwen2-vl-2b": 2}
M_BATCH, M_PROMPT, M_FORCED = 4, 128, 4     # the cache check
M_CPU_PROMPT, M_CPU_STEPS = 64, 4
M_CONTINUE = 100                 # chunked prefill vs token-by-token decode
M_TEXT = 64                      # qwen2-vl: text tokens after the image
# Relative L2 error of one step's logits (`rel_err`), per family: M_TOL
# for the card against the CPU at M_CPU_LAYERS (MoE with the CPU routed
# as the card), M_CACHE_TOL for cache against forward at full depth.
# `tools/lm_tolerance.py --arch <name>` on an H100 machine's host CPU:
# bfloat16 against float32 forward 0.020 / 0.037 for deepseek at 2 / 4
# layers (4.8% / 8.1% of its top-6 choices flipped), rwkv 0.010 / 0.018
# / 0.083 at 2 / 4 / 8, zamba2 0.020 / 0.029 at 6 / 12; the
# mis-computations 0.15-1.15. Deep random bfloat16 stacks amplify
# rounding (rwkv: 8x from 2 to 8 layers) and MoE routes discretely: on
# the card at 28 layers deepseek's cache against forward read
# 0.017-0.057 and routing one rank down 0.43; unreplayed, 2 layers card
# against CPU read up to 0.077 with 3.7% of the choices flipped.
# The reference's own bfloat16 cache against forward beside the port's,
# on the CPU with the same weights (`tools/cache_vs_forward_reference.py`,
# widths cut to d_model 256, depths as above), reference / port max:
# deepseek 0.0037 / 0.0000 at 2 layers, 0.0075 / 0.0000 at 4; rwkv6
# 0.0000 / 0.0009 at 2, 0.0000 / 0.0041 at 4, 0.0050 / 0.0087 at 8;
# zamba2 0.0001 / 0.0000 at 6, 0.0066 / 0.0013 at 12. The port's rwkv6
# reads above the reference's (ROADMAP C.8); every reading is far below
# the 0.1 gate, which stays.
M_TOL = {name: LM_TOL for name in M_ARCHS}
M_CACHE_TOL = {"deepseek-moe-16b": 0.1, "rwkv6-7b": 0.1, "zamba2-7b": 0.1,
               "qwen2-vl-2b": LM_TOL}


class Patched:
    """Context manager: ``module.name`` is ``make(original)`` inside, the
    original again on exit."""

    def __init__(self, module, name: str, make):
        self.module, self.name, self.make = module, name, make

    def __enter__(self):
        self.right = getattr(self.module, self.name)
        setattr(self.module, self.name, self.make(self.right))
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.right)


def family_wrong(name: str) -> tuple:
    """(what it is, a context manager) of the mis-computation that phase
    M's card-against-CPU check must flag for ``name``: each token routed
    to its experts of ranks 2..k+1 (MoE), a decode step reading the
    recurrent state with its last two axes swapped (rwkv's WKV state K
    and V, zamba2's SSD state P and N: a layout fault), and a decode
    whose M-RoPE positions are its sequence index (cache_len)
    instead of the caller's text position (qwen2-vl). (RWKV's token-shift
    mixes and LoRA start at zero, so a random model cannot show a
    token-shift fault.)"""
    from repro_torch.models import api, mamba, moe, rwkv

    if name.startswith(("deepseek-moe", "llama4")):
        def shifted(right):
            def top_k(p, k):
                v, i = right(p, k + 1)
                return v[..., 1:], i[..., 1:]
            return top_k
        return "routing one rank down", Patched(moe, "top_k", shifted)
    if name.startswith("rwkv"):
        return "a decode reading the WKV state transposed", Patched(
            rwkv, "wkv6_step", lambda right: lambda r, k, v, lw, u, s: right(
                r, k, v, lw, u, s.transpose(-1, -2)))
    if name.startswith("zamba"):
        def transposed(right):
            def block(params, x, state, cfg, *, mode):
                if mode == "decode":
                    state = dict(state, s=state["s"].transpose(-1, -2))
                return right(params, x, state, cfg, mode=mode)
            return block
        return "a decode reading the SSD state transposed", Patched(
            mamba, "mamba_block", transposed)

    def sequential(right):
        def positions(batch, cfg, *, mode):
            pos = right(batch, cfg, mode=mode)
            if mode == "decode":
                pos = batch["cache_len"].reshape(-1, 1, 1).expand_as(pos)
            return pos
        return positions
    return "a decode at its sequence index, not its M-RoPE position", \
        Patched(api, "_positions", sequential)


class TopK:
    """Context manager keeping every MoE routing choice (each
    `models.moe.top_k` call's indices, on the CPU) in ``calls``; given
    ``replay`` (another run's ``calls``), each call routes to those
    experts instead, with this run's own probabilities as the gates."""

    def __init__(self, replay=None):
        self.calls, self.replay = [], replay

    def __enter__(self):
        from repro_torch.models import moe

        def record(right):
            def top_k(p, k):
                v, i = right(p, k)
                if self.replay is not None:
                    i = self.replay[len(self.calls)].to(p.device)
                    v = p.gather(-1, i)
                self.calls.append(i.cpu())
                return v, i
            return top_k
        self.patch = Patched(moe, "top_k", record).__enter__()
        return self

    def __exit__(self, *exc):
        self.patch.__exit__()


def cut_params(params, cfg, n_layers: int) -> tuple:
    """(``cfg`` cut to ``n_layers``, ``params`` with each segment's first
    layers as views, as the cut config's plan takes them)."""
    import dataclasses

    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import tree_map

    cut = dataclasses.replace(cfg, num_layers=n_layers)
    out = dict(params)
    out["stack"] = {f"seg{i}": tree_map(lambda t, n=seg.repeats: t[:n],
                                        params["stack"][f"seg{i}"])
                    for i, seg in enumerate(tfm.stack_plan(cut))}
    return cut, out


def family_positions(cfg, lo: int, hi: int, B: int, dev):
    """qwen2-vl's (B, hi - lo, 3) positions of sequence indices [lo, hi):
    the first vlm_patches positions are one square image (t = 0, h = row,
    w = column), the text after it at t = h = w, counting on from the
    image's side."""
    import numpy as np
    import torch

    n = cfg.vlm_patches
    side = int(round(n ** 0.5))
    i = np.arange(lo, hi)
    img = i < n
    text = i - n + side
    pos = np.stack([np.where(img, 0, text), np.where(img, i // side, text),
                    np.where(img, i % side, text)], -1)
    return torch.as_tensor(np.broadcast_to(pos[None], (B, hi - lo, 3))
                           .copy(), device=dev)


def family_batch(cfg, tokens, dev):
    """``tokens`` (B, S) as a batch of ``cfg``'s model; for qwen2-vl also
    patch embeddings from a seed and `family_positions`."""
    import numpy as np
    import torch

    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    if cfg.vlm_patches:
        B, S = tokens.shape
        rng = np.random.default_rng(M_DATA_SEED + 5)
        batch["patch_emb"] = torch.as_tensor(rng.normal(
            0, 0.02, (B, cfg.vlm_patches, cfg.d_model)).astype(np.float32),
            device=dev)
        batch["positions"] = family_positions(cfg, 0, S, B, dev)
    return batch


def decode_step_batch(cfg, tok, t: int, dev):
    """One teacher-forced decode batch: tokens ``tok`` (B, 1) at position
    t (with qwen2-vl's (B, 1, 3) positions)."""
    import torch

    B = tok.shape[0]
    batch = {"tokens": torch.as_tensor(tok, device=dev),
             "cache_len": torch.full((B,), t, device=dev)}
    if cfg.vlm_patches:
        batch["positions"] = family_positions(cfg, t, t + 1, B, dev)
    return batch


def family_cache_check(name, model, params, dev, card: str) -> dict:
    """Prefill M_BATCH prompts of M_PROMPT tokens (one length: recurrent
    state cannot be padded; qwen2-vl's image first), then M_FORCED
    teacher-forced decode steps, each step's logits against
    `model.forward` over the extended sequences, within M_CACHE_TOL; the
    same decodes under `family_wrong`'s mis-computation must read above
    it. MoE runs the decodes at a capacity factor of E / k, which drops
    no token (otherwise the grouping of the tokens decides which are
    dropped), and, at its own capacity, the prefill's last position
    against forward over the same tokens (the same groups)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import build_model, init_cache

    cfg = model.cfg
    rng = np.random.default_rng(M_DATA_SEED)
    n = M_PROMPT + (cfg.vlm_patches or 0)
    toks = rng.integers(1, cfg.vocab_size, (M_BATCH, n + M_FORCED))
    first = family_batch(cfg, toks[:, :n], dev)
    out = {}
    mdl = model
    what, wrong = family_wrong(name)
    with torch.no_grad():
        if cfg.moe is not None:
            full, aux = model.forward(params, first)
            last, _ = model.prefill(params, first, init_cache(
                model, M_BATCH, LM_MAX_LEN, device=dev))
            out.update(prefill_vs_forward=rel_err(last[:, 0], full[:, -1]),
                       aux=float(aux))
            del full
            m = cfg.moe
            mdl = build_model(dataclasses.replace(cfg, moe=dataclasses.replace(
                m, capacity_factor=m.num_experts / m.top_k)), device=dev)
        full, _ = mdl.forward(params, family_batch(cfg, toks, dev))
        for tag in ("right", "wrong"):
            with (wrong if tag == "wrong" else contextlib.nullcontext()):
                cache = init_cache(mdl, M_BATCH, LM_MAX_LEN, device=dev)
                last, cache = mdl.prefill(params, first, cache)
                errs = [rel_err(last[:, 0], full[:, n - 1])]
                for t in range(M_FORCED):
                    got, cache = mdl.decode(params, decode_step_batch(
                        cfg, toks[:, n + t:n + t + 1], n + t, dev), cache)
                    errs.append(rel_err(got[:, 0], full[:, n + t]))
            out["cache_vs_forward" if tag == "right" else "wrong"] = errs
            del cache
        del full
    errs, bad = out["cache_vs_forward"], out["wrong"][1:]
    tol = M_CACHE_TOL[name]
    print(f"{name} cache vs forward: {M_BATCH} prompts of {n} tokens, "
          f"prefill then {M_FORCED} teacher-forced decode steps"
          + (" at capacity factor E/k (no drops)" if cfg.moe else "")
          + f": relative error {min(errs):.5f}-{max(errs):.5f} (tol {tol});"
          f" {what} reads {min(bad):.5f}-{max(bad):.5f} on the decode steps"
          + (f"; at its own capacity the prefill's last position vs forward "
             f"{out['prefill_vs_forward']:.5f}, aux loss {out['aux']:.5f}"
             if cfg.moe else "") + f" [{card}]")
    if max(errs + [out.get("prefill_vs_forward", 0.0)]) > tol:
        raise AssertionError(f"phase M {name}: cache vs forward "
                             f"{max(errs):.5f} > {tol}")
    if min(bad) <= tol:
        raise AssertionError(f"phase M {name}: the tolerance {tol} does not "
                             f"flag {what} ({min(bad):.5f})")
    return out


def family_vs_cpu(name, cfg, params, dev, card: str) -> dict:
    """The same seed's first M_CPU_LAYERS layers at full width on the
    card and on the host CPU: one prompt prefilled and M_CPU_STEPS
    teacher-forced decode steps, each step's logits within M_TOL; and
    what the check reads from `family_wrong`'s mis-computation on the
    card (the run fails unless the tolerance flags its decode steps).
    MoE routes discretely: a near-tie that rounds apart sends a token to
    another expert. So for MoE the CPU also replays the card's top-k
    choices (its own probabilities as the gates), the run held to M_TOL
    is the card against that replay, and the share of choices that
    differ and the error without the replay are printed."""
    import numpy as np
    import torch

    from repro_torch.models import build_model, init_cache
    from repro_torch.models.layers import tree_map

    cut, cparams = cut_params(params, cfg, M_CPU_LAYERS[name])
    cpu_params = tree_map(lambda t: t.cpu(), cparams)
    rng = np.random.default_rng(M_DATA_SEED + 1)
    n = M_CPU_PROMPT + (cut.vlm_patches or 0)
    toks = rng.integers(1, cut.vocab_size, (1, n + M_CPU_STEPS))
    what, wrong = family_wrong(name)
    runs = [("cpu", "cpu", cpu_params), ("card", dev, cparams),
            ("wrong", dev, cparams)]
    if cfg.moe is not None:
        runs.append(("replay", "cpu", cpu_params))
    outs, routes = {}, {}
    with torch.no_grad():
        for tag, d, p in runs:
            m = build_model(cut, device=d)
            with TopK(routes["card"] if tag == "replay" else None) as rec, \
                    (wrong if tag == "wrong" else contextlib.nullcontext()):
                c = init_cache(m, 1, LM_MAX_LEN, device=d)
                lg, c = m.prefill(p, family_batch(cut, toks[:, :n], d), c)
                seq = [lg[:, 0].cpu()]
                for t in range(M_CPU_STEPS):
                    lg, c = m.decode(p, decode_step_batch(
                        cut, toks[:, n + t:n + t + 1], n + t, d), c)
                    seq.append(lg[:, 0].cpu())
            outs[tag], routes[tag] = seq, rec.calls
    ref = outs["replay" if cfg.moe is not None else "cpu"]
    card_err = [rel_err(a, b) for a, b in zip(outs["card"], ref)]
    wrong_err = [rel_err(a, b) for a, b in zip(outs["wrong"], outs["cpu"])]
    res = {"layers": cut.num_layers, "card_vs_cpu": card_err,
           "wrong": wrong_err}
    flips = ""
    if cfg.moe is not None:
        a = torch.cat([r.reshape(-1) for r in routes["card"]])
        b = torch.cat([r.reshape(-1) for r in routes["cpu"]])
        res["topk_differ"] = float((a != b).float().mean())
        res["card_vs_cpu_own_routing"] = [
            rel_err(x, y) for x, y in zip(outs["card"], outs["cpu"])]
        flips = (f" with the CPU routed as the card; {res['topk_differ']:.2%}"
                 f" of {a.numel()} top-{cfg.moe.top_k} choices differ, and "
                 f"each routed its own way the runs read "
                 f"{min(res['card_vs_cpu_own_routing']):.5f}-"
                 f"{max(res['card_vs_cpu_own_routing']):.5f}")
    tol = M_TOL[name]
    print(f"{name} card vs CPU: {cut.num_layers} layers, one {n}-token "
          f"prompt, prefill + {M_CPU_STEPS} teacher-forced steps; relative "
          f"error {min(card_err):.5f}-{max(card_err):.5f} (tol {tol})"
          f"{flips}; {what} reads {min(wrong_err[1:]):.5f}-"
          f"{max(wrong_err[1:]):.5f} on the decode steps [{card}]")
    if max(card_err) > tol:
        raise AssertionError(f"phase M {name}: card vs CPU "
                             f"{max(card_err):.5f} > {tol}")
    if min(wrong_err[1:]) <= tol:
        raise AssertionError(f"phase M {name}: the tolerance {tol} does not "
                             f"flag {what} ({min(wrong_err[1:]):.5f})")
    return res


def family_continue(name, model, params, dev, card: str) -> dict:
    """rwkv and zamba2: one M_CONTINUE-token prompt prefilled in chunks
    against the same prompt fed token by token through decode (the
    reference's `test_wkv6_decode_continues_scan`, at full width and
    depth), the last position's logits within M_TOL. It runs in float32
    compute on the same (bfloat16-valued) weights, as the reference's
    test runs in float32: in bfloat16 the 1-row products of 100 decodes
    round apart from the 100-row ones of the prefill, and 32 random
    layers amplify that to ~0.1 (the whole rounding error of the dtype;
    `M_TOL`'s note), which would hide what this check is for."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import build_model, init_cache

    f32 = build_model(dataclasses.replace(model.cfg,
                                          compute_dtype=torch.float32),
                      device=dev)
    rng = np.random.default_rng(M_DATA_SEED + 2)
    toks = torch.as_tensor(rng.integers(1, model.cfg.vocab_size,
                                        (1, M_CONTINUE)), device=dev)
    with torch.no_grad():
        want, _ = f32.prefill(params, {"tokens": toks}, init_cache(
            f32, 1, LM_MAX_LEN, device=dev))
        c = init_cache(f32, 1, LM_MAX_LEN, device=dev)
        for t in range(M_CONTINUE):
            got, c = f32.decode(params, {
                "tokens": toks[:, t:t + 1],
                "cache_len": torch.tensor([t], device=dev)}, c)
    err = rel_err(got[:, 0], want[:, 0])
    print(f"{name} one {M_CONTINUE}-token prompt, chunked prefill vs "
          f"{M_CONTINUE} decode steps in float32 compute: relative error "
          f"{err:.6f} (tol {M_TOL[name]}) [{card}]")
    if err > M_TOL[name]:
        raise AssertionError(f"phase M {name}: chunked prefill vs decode "
                             f"{err:.5f} > {M_TOL[name]}")
    return {"prefill_vs_decode_f32": err}


def family_serving(name, model, params, dev, card: str) -> dict:
    """`Engine(slots=4, max_len=1024)` on phase L's 8 requests (in this
    vocabulary), greedy twice (the second timed) and at temperature 0.8
    once: every request finishes, the greedy repeat identical, the
    sampled tokens not the greedy ones; MoE also through
    `PagedEngine(page_size=16)` (every page freed; its token agreement
    with dense printed: the paged prefill's chunks group the tokens
    otherwise, so other tokens overflow capacity), rwkv and zamba2
    refused by it, typed. One decode step's times beside its bound, and
    the generated tokens/s."""
    import torch

    from repro_torch.serve.engine import Engine, PagedEngine
    from repro_torch.serve.errors import PagedCacheUnsupported

    cfg = model.cfg
    reqs = lm_prompts(LM_REQUESTS, *LM_SERVE_PROMPT, cfg.vocab_size,
                      LM_DATA_SEED + 2)
    tag = f"phase M {name}"
    with torch.no_grad():
        greedy, _, _, _, e2e = serve_run(Engine, model, params, reqs,
                                         slots=LM_SLOTS, dev=dev, tag=tag)
        timed, teng, walls, admits, _ = serve_run(
            make_timed_engine(), model, params, reqs, slots=LM_SLOTS,
            dev=dev, tag=tag)
        samp = serve_run(Engine, model, params, reqs, slots=LM_SLOTS,
                         dev=dev, temperature=LM_TEMPERATURE, tag=tag)[0]
    if greedy != timed:
        raise AssertionError(f"{tag}: repeated greedy runs differ")
    if samp == greedy:
        raise AssertionError(f"{tag}: temperature 0.8 gave the greedy tokens")
    res = {"e2e_tok_s": LM_REQUESTS * LM_MAX_NEW / e2e,
           "tokens": {str(k): v for k, v in greedy.items()}}
    if cfg.moe is not None:
        with torch.no_grad():
            pout, peng, _, _, _ = serve_run(
                PagedEngine, model, params, reqs, slots=LM_SLOTS, dev=dev,
                tag=tag, page_size=PAGE_SIZE)
        if peng.pool.n_free != peng.pool.capacity:
            raise AssertionError(f"{tag}: pages leaked")
        res["paged_agreement"] = token_agreement(pout, greedy)
        paged = (f"; PagedEngine(page_size={PAGE_SIZE}): every request "
                 f"finished, every page freed, token agreement with dense "
                 f"{res['paged_agreement']:.3f}")
    else:
        try:
            PagedEngine(model, params, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                        device=dev, page_size=PAGE_SIZE)
        except PagedCacheUnsupported:
            paged = "; PagedEngine refuses it (PagedCacheUnsupported)"
        else:
            raise AssertionError(f"{tag}: PagedEngine took recurrent state")
    print(f"{name} server: Engine(slots={LM_SLOTS}, max_len={LM_MAX_LEN}) "
          f"served {LM_REQUESTS} requests of {min(map(len, reqs))}-"
          f"{max(map(len, reqs))} prompt tokens, max_new {LM_MAX_NEW}, "
          f"greedy twice and at temperature {LM_TEMPERATURE}: every "
          f"request finished, the greedy repeat identical{paged}; "
          f"{res['e2e_tok_s']:.1f} generated tokens/s end to end [{card}]")
    from repro_torch.analysis.roofline import family_work

    res["decode"] = decode_times(
        teng, walls, admits, cfg, None, None, model, card, tag=name,
        work=lambda n_rows, contexts: family_work(
            model, teng.params, n_rows, contexts, LM_MAX_LEN))
    return res


def family_decode_alone(name, model, params, dev, card: str) -> dict:
    """qwen2-vl, which no engine serves (the reference's `Engine` passes
    no positions): one decode at M_BATCH rows after a prefill of the
    image and M_TEXT text tokens; host wall (median of 10 calls), the
    card's busy time and launches, the bound."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.models import init_cache

    cfg = model.cfg
    rng = np.random.default_rng(M_DATA_SEED + 3)
    n = cfg.vlm_patches + M_TEXT
    toks = rng.integers(1, cfg.vocab_size, (M_BATCH, n + 1))
    with torch.no_grad():
        _, cache = model.prefill(params, family_batch(cfg, toks[:, :n], dev),
                                 init_cache(model, M_BATCH, LM_MAX_LEN,
                                            device=dev))
        batch = decode_step_batch(cfg, toks[:, n:], n, dev)
        walls = []
        for _ in range(10):
            torch.cuda.synchronize()
            t = time.perf_counter()
            model.decode(params, batch, cache)[0].argmax(-1).cpu()
            walls.append((time.perf_counter() - t) * 1e3)
        busy, launches = device_busy(lambda: model.decode(params, batch,
                                                          cache))
    host = statistics.median(walls)
    from repro_torch.analysis.roofline import family_work

    nbytes, ops = family_work(model, params, M_BATCH, [n] * M_BATCH,
                              LM_MAX_LEN)
    bms, by = bound_ms(nbytes, ops, PEAK_BF16)
    print(f"{name} decode at {M_BATCH} rows after {n} tokens: {host:.3f} ms "
          f"host wall (median of 10); the card busy {busy:.3f} ms over "
          f"{launches} launches (profiler), idle {1 - busy / host:.1%}; "
          f"bound {bms:.4f} ms ({by}: {nbytes / 1e9:.3f} GB) [{card}]")
    return {"host_ms": host, "device_busy_ms": busy, "launches": launches,
            "idle_share": 1 - busy / host, "bound_ms": bms, "bound_by": by,
            "bytes": nbytes}


def family_path(name, dev, card: str, cfg=None) -> dict:
    """One family at its full width and depth on the card (``cfg`` cuts
    it for a rehearsal): the leaf-at-a-time load, the cache check, card
    against CPU, then serving (rwkv and zamba2 also the chunked prefill
    against decode; qwen2-vl one timed decode)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_cast_params
    from repro_torch.models.layers import param_count, tree_items

    cfg = cfg or get_config(name)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = init_cast_params(model, M_PARAM_SEED, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_params = param_count(model.schema)
    resident = sum(t.numel() * t.element_size() for _, t in tree_items(params))
    res = {"params": n_params, "resident_gb": resident / 1e9,
           "load_s": load_s,
           "load_peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"{name}: {n_params:,} parameters ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab_size}), drawn from seed "
          f"{M_PARAM_SEED} and cast one leaf at a time in {load_s:.1f} s: "
          f"{resident / 1e9:.3f} GB resident; "
          + memory_line("load peak") + f" [{card}]")
    res["cache"] = family_cache_check(name, model, params, dev, card)
    res["cpu"] = family_vs_cpu(name, cfg, params, dev, card)
    if cfg.vlm_patches:
        res["decode"] = family_decode_alone(name, model, params, dev, card)
    else:
        if cfg.ssm is not None:
            res["continue"] = family_continue(name, model, params, dev,
                                              card)
        res["serve"] = family_serving(name, model, params, dev, card)
    res["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"{name}: " + memory_line("peak"))
    return res


def phase_m(dev, card: str, cfgs=None) -> dict:
    """Phase M: deepseek-moe-16b, rwkv6-7b, zamba2-7b and qwen2-vl-2b at
    full width and depth (``cfgs`` {name: config} cuts them for a
    rehearsal), each with the launch counts set to 0 just before and read
    just after: no kernel of the port may launch (these paths reach no
    Pallas kernel in the reference). Each model is freed before the
    next."""
    import torch

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    out = {}
    for name in M_ARCHS:
        res, launches = counted(lambda: family_path(
            name, dev, card, (cfgs or {}).get(name)))
        if any(n for entries in launches.values() for n in entries.values()):
            raise AssertionError(f"phase M {name} launched a kernel: "
                                 f"{launches}")
        out[name] = res
        gc.collect()
        torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"phase M: {secs:.1f} s; no kernel of the port launched "
          f"(llama4-maverick, ~400B parameters, fits on no one card and is "
          f"held to the reference on the CPU only)")
    out["seconds"] = secs
    return out


# phase T: training at full width (no kernel: the reference's training
# path reaches no Pallas kernel and has no custom_vjp)
T_ARCH, T2_ARCH = "qwen1.5-0.5b", "deepseek-moe-16b"
T_PARAM_SEED, T_DATA_SEED = 0, 0
# launch/train.py's defaults: batch 8 of 256 tokens, lr 3e-3, 100 steps
# (warmup max(10, steps / 20), the cosine to step 100), fp32 m and v
T_BATCH, T_SEQ, T_LR, T_SCHEDULE = 8, 256, 3e-3, 100
T_RUN, T_RESUME_AT = 6, 3        # determinism: 6 steps; resume after 3
T_CPU_LAYERS, T_CPU_BATCH = 2, (2, 128)
T2_LAYERS, T2_BATCH, T2_RUN = 4, (2, 512), 3   # deepseek: dense + 3 MoE
T2_CPU_LAYERS, T2_CPU_BATCH = 2, (1, 256)
# Relative L2 error of the loss and of the whole gradient tree, card
# against the host CPU, both in bfloat16 compute. `tools/
# train_tolerance.py` on an H100 machine's host CPU: bfloat16 against
# float32 compute (the whole rounding error of the dtype) 0.0165 / 0.0202
# for qwen at 2 / 4 layers, 0.0173 for deepseek at 2 (its float32 pass on
# the bfloat16 routing; 7.2% of the top-6 choices flip unreplayed); the
# head's use of the tied embedding detached 0.185-0.202. On the card the
# check read 0.0102 (qwen) and 0.0110 (deepseek). 0.05 sits 2.5x above
# the dtype's whole error and 4x under the mis-computation.
TRAIN_TOL = 0.05
# the update of `adamw_update` on identical float32 gradients, card
# against CPU: elementwise float32 in both, another reduction order for
# the global norm only (read 5.7e-8 on the card; the bias correction
# dropped 0.63)
ADAM_TOL = 1e-6


def t_opt(**kw):
    """`launch/train.py`'s optimizer settings at ``T_SCHEDULE`` steps."""
    from repro_torch.train import optim

    return optim.OptConfig(lr=T_LR, warmup_steps=max(10, T_SCHEDULE // 20),
                           total_steps=T_SCHEDULE, **kw)


def t_batch(vocab: int, rows: int, seq: int, step: int = 0) -> dict:
    """The synthetic loader's batch ``step`` (numpy, on the host)."""
    from repro_torch.data.pipeline import DataConfig, ShardedLoader

    return ShardedLoader(DataConfig(vocab_size=vocab, seq_len=seq,
                                    global_batch=rows,
                                    seed=T_DATA_SEED)).batch(step)


def batch_tree(batch: dict) -> dict:
    import torch

    return {k: (v.shape, torch.int32) for k, v in batch.items()}


def tree_rel_err(got: list, want: list) -> float:
    """One relative L2 error over two lists of tensors (float64 sums)."""
    num = sum(float((a.double() - b.double()).square().sum())
              for a, b in zip(got, want))
    den = sum(float(b.double().square().sum()) for b in want)
    return math.sqrt(num / den)


def loss_and_grads(model, params, batch: dict, dev) -> tuple:
    """(loss, the gradient leaves on the host in float32) of
    ``model.loss`` at ``params`` (a tree on ``dev``; left unchanged)."""
    import torch

    from repro_torch.models.layers import tree_from_items, tree_items

    items = [(path, t.detach().requires_grad_())
             for path, t in tree_items(params)]
    tree = tree_from_items(items)
    tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    loss, metrics = model.loss(tree, tb)
    grads = torch.autograd.grad(loss, [t for _, t in items])
    return float(loss.detach()), float(metrics["aux"]), [g.float().cpu()
                                                 for g in grads]


def head_detached():
    """The mis-computation (c1): the head's use of the tied embedding
    detached, so the embedding's gradient keeps the lookup's part only."""
    from repro_torch.models import layers

    return Patched(layers, "unembed", lambda right: lambda p, x: right(
        {"embedding": p["embedding"].detach()}, x))


def no_bias_correction():
    """The mis-computation (c2): Adam's moments used without their bias
    correction."""
    from repro_torch.train import optim

    return Patched(optim, "_update_leaf", lambda right: lambda *a: right(
        *a[:6], 1.0, 1.0, a[8]))


def train_vs_cpu(tag, cfg, params, dev, card: str, n_layers: int,
                 rows_seq: tuple, wrong=None) -> dict:
    """The first ``n_layers`` layers of ``params`` at full width: one
    batch's loss and gradient tree on the card against the host CPU (the
    same float32 weights), relative L2 within TRAIN_TOL; for MoE the CPU
    replays the card's top-k choices and the share of choices that
    differ without the replay is printed; ``wrong`` (what, a context
    manager) is a mis-computation the check must flag on the card."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_map

    cut, views = cut_params(params, cfg, n_layers)
    card_p = tree_map(lambda t: t.detach().clone(), views)
    cpu_p = tree_map(lambda t: t.detach().cpu(), views)
    batch = t_batch(cut.vocab_size, *rows_seq)
    moe = cut.moe is not None
    m_card, m_cpu = build_model(cut, device=dev), build_model(cut, device="cpu")
    with TopK() as rec:
        loss, aux, grads = loss_and_grads(m_card, card_p, batch, dev)
    with TopK(rec.calls if moe else None):
        cpu_loss, cpu_aux, cpu_grads = loss_and_grads(m_cpu, cpu_p, batch,
                                                      "cpu")
    res = {"layers": n_layers, "loss": loss, "cpu_loss": cpu_loss,
           "loss_rel": abs(loss - cpu_loss) / abs(cpu_loss),
           "grad_rel": tree_rel_err(grads, cpu_grads)}
    flips = ""
    if moe:
        with torch.no_grad(), TopK() as own:
            m_cpu.loss(cpu_p, {k: torch.as_tensor(v)
                               for k, v in batch.items()})
        # the forward's choices (remat routes again in the backward pass)
        a = torch.cat([r.reshape(-1) for r in rec.calls[:len(own.calls)]])
        b = torch.cat([r.reshape(-1) for r in own.calls])
        res.update(aux=aux, cpu_aux=cpu_aux,
                   topk_differ=float((a != b).float().mean()))
        flips = (f"; the CPU replays the card's routing: "
                 f"{res['topk_differ']:.2%} of {a.numel()} top-"
                 f"{cut.moe.top_k} choices differ on its own; aux "
                 f"{aux:.6f} / {cpu_aux:.6f}")
    if wrong is not None:
        what, ctx = wrong
        with ctx:
            _, _, bad = loss_and_grads(m_card, card_p, batch, dev)
        res["wrong"] = tree_rel_err(bad, cpu_grads)
        flips += f"; {what} reads {res['wrong']:.5f}"
    del card_p
    print(f"{tag} card vs CPU: {n_layers} layers at full width, one "
          f"{rows_seq[0]} x {rows_seq[1]} batch: loss {loss:.6f} / "
          f"{cpu_loss:.6f} (relative {res['loss_rel']:.2e}), gradient "
          f"tree relative L2 {res['grad_rel']:.5f} (tol {TRAIN_TOL})"
          f"{flips} [{card}]")
    if max(res["loss_rel"], res["grad_rel"]) > TRAIN_TOL:
        raise AssertionError(f"phase {tag}: card vs CPU {res} > {TRAIN_TOL}")
    if wrong is not None and res["wrong"] <= TRAIN_TOL:
        raise AssertionError(f"phase {tag}: TRAIN_TOL {TRAIN_TOL} does not "
                             f"flag {wrong[0]} ({res['wrong']:.5f})")
    return res, cut, cpu_p, cpu_grads


def adam_vs_cpu(cut, cpu_p, cpu_grads, dev, card: str) -> dict:
    """`adamw_update` on identical gradients (the CPU's of
    `train_vs_cpu`), one step on the card and on the CPU from the same
    parameters: the update's relative L2 within ADAM_TOL; and what the
    check reads from the update without its bias correction (the run
    fails unless ADAM_TOL flags it)."""
    from repro_torch.models.layers import tree_from_items, tree_items
    from repro_torch.train import optim

    oc = t_opt()
    paths = [p for p, _ in tree_items(cpu_p)]
    g_tree = tree_from_items(zip(paths, cpu_grads))

    def update(device, wrong=False):
        p = tree_from_items((path, t.to(device).clone())
                            for path, t in tree_items(cpu_p))
        g = tree_from_items((path, t.to(device)) for path, t in
                            tree_items(g_tree))
        with (no_bias_correction() if wrong else contextlib.nullcontext()):
            optim.adamw_update(g, optim.init_opt_state(p, oc), p, oc)
        return [(new.cpu() - old) for (_, new), (_, old) in
                zip(tree_items(p), tree_items(cpu_p))]

    want = update("cpu")
    got = update(dev)
    bad = update(dev, wrong=True)
    res = {"update_rel": tree_rel_err(got, want),
           "wrong": tree_rel_err(bad, want)}
    print(f"T1 adamw_update on identical gradients ({len(paths)} leaves), "
          f"card vs CPU: update relative L2 {res['update_rel']:.2e} (tol "
          f"{ADAM_TOL}); the bias correction dropped reads "
          f"{res['wrong']:.5f} [{card}]")
    if res["update_rel"] > ADAM_TOL:
        raise AssertionError(f"phase T1: adamw_update card vs CPU "
                             f"{res['update_rel']} > {ADAM_TOL}")
    if res["wrong"] <= ADAM_TOL:
        raise AssertionError("phase T1: ADAM_TOL does not flag the dropped "
                             "bias correction")
    return res


def same_tree(a, b) -> bool:
    import torch

    from repro_torch.models.layers import tree_items

    return all(x.dtype == y.dtype and torch.equal(x.detach(), y.detach())
               for (_, x), (_, y) in zip(tree_items(a), tree_items(b)))


def t_run(model, oc, dev, state, n: int, rows: int = T_BATCH,
          seq: int = T_SEQ, ckpt_dir=None, every: int = 0):
    """``launch/train.py``'s loop on the synthetic loader: n steps of
    rows x seq tokens, every step logged."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.step import make_train_step

    cfg = model.cfg
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                    global_batch=rows, seed=T_DATA_SEED)
    bundle = make_train_step(model, oc, batch_tree(t_batch(
        cfg.vocab_size, rows, seq)), device=dev)
    lc = LoopConfig(n_steps=n, ckpt_every=every, ckpt_dir=ckpt_dir or "",
                    log_every=1, async_ckpt=True)
    return train(model, bundle, dc, lc, state, device=dev, log=None)


def phase_t1(dev, card: str, cfg=None) -> dict:
    """T1: qwen1.5-0.5b at full width and depth (``cfg`` cuts it for a
    rehearsal), float32 weights from seed 0, bfloat16 compute,
    `launch/train.py`'s defaults: (a) card vs CPU at T_CPU_LAYERS layers
    with the head detached as the mis-computation, (b) `adamw_update` on
    identical gradients with the bias correction dropped as the
    mis-computation, (d) two T_RUN-step runs from seed 0 bitwise equal,
    and a run checkpointed (async) after T_RESUME_AT steps and resumed by
    the loop from the checkpoint bitwise the uninterrupted one, (e) the
    step's host wall, busy time, launches, idle share, tokens/s and peak
    memory beside its bound."""
    import statistics
    import tempfile

    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.step import init_state, make_train_step

    cfg = cfg or get_config(T_ARCH)
    oc = t_opt()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev)
    res = {}
    state_a = init_state(model, oc, T_PARAM_SEED, device=dev)
    res["cpu"], cut, cpu_p, cpu_grads = train_vs_cpu(
        "T1", cfg, state_a["params"], dev, card, T_CPU_LAYERS, T_CPU_BATCH,
        wrong=("the head's use of the tied embedding detached",
               head_detached()))
    res["adam"] = adam_vs_cpu(cut, cpu_p, cpu_grads, dev, card)
    del cpu_p, cpu_grads
    gc.collect()

    state_a, hist_a = t_run(model, oc, dev, state_a, T_RUN)
    state_b, hist_b = t_run(model, oc, dev, init_state(
        model, oc, T_PARAM_SEED, device=dev), T_RUN)
    losses = [h["loss"] for h in hist_a]
    same = losses == [h["loss"] for h in hist_b] and same_tree(
        state_a["params"], state_b["params"])
    with tempfile.TemporaryDirectory(prefix="phase_t_") as d:
        t0 = time.perf_counter()
        t_run(model, oc, dev, init_state(model, oc, T_PARAM_SEED,
                                          device=dev),
               T_RESUME_AT, ckpt_dir=d, every=T_RESUME_AT)
        save_s = time.perf_counter() - t0
        if ckpt.latest_step(d) != T_RESUME_AT:
            raise AssertionError("phase T1: no checkpoint written")
        t0 = time.perf_counter()
        # the loop resumes from the latest step; a period past the run's
        # end writes no second checkpoint
        state_c, hist_c = t_run(model, oc, dev, None, T_RUN, ckpt_dir=d,
                                 every=T_RUN + 1)
        resume_s = time.perf_counter() - t0
    resumed = [h["step"] for h in hist_c] == list(
        range(T_RESUME_AT + 1, T_RUN + 1)) and \
        [h["loss"] for h in hist_c] == losses[T_RESUME_AT:] and \
        same_tree(state_c, state_a)
    res.update(losses=losses, repeat_equal=same, resume_equal=resumed,
               save_s=save_s, resume_s=resume_s)
    print(f"T1 {cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}: losses of {T_RUN} steps from seed "
          f"{T_PARAM_SEED} " + ", ".join(f"{x:.5f}" for x in losses)
          + f"; a second run bitwise equal: {same}; {T_RESUME_AT} steps, an "
          f"async checkpoint, a resume by the loop and {T_RUN - T_RESUME_AT}"
          f" more steps bitwise the uninterrupted run (losses and every "
          f"leaf of the state): {resumed} ({save_s:.1f} s to step "
          f"{T_RESUME_AT} with the checkpoint written, {resume_s:.1f} s to "
          f"restore and finish) [{card}]")
    if not same:
        raise AssertionError(f"phase T1: two same-seed runs differ: "
                             f"{losses} / {[h['loss'] for h in hist_b]}")
    if not resumed:
        raise AssertionError(f"phase T1: the resumed run differs: "
                             f"{[(h['step'], h['loss']) for h in hist_c]}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"phase T1: the loss did not fall: {losses}")
    del state_c
    gc.collect()

    # (e) readings: not gated
    host = statistics.median(h["time_s"] * 1e3 for h in hist_a[1:])
    del state_a
    batch = t_batch(cfg.vocab_size, T_BATCH, T_SEQ, T_RUN)
    step = make_train_step(model, oc, batch_tree(batch), device=dev).step_fn
    overall = torch.cuda.max_memory_allocated()
    held, step_peak = step_memory(lambda: step(state_b, batch))
    busy, launches = device_busy(lambda: step(state_b, batch))
    from repro_torch.analysis.roofline import train_work

    work = train_work(model, T_BATCH * T_SEQ, T_SEQ, T_BATCH)
    res["time"] = {"host_ms": host, "device_busy_ms": busy,
                   "launches": launches, "idle_share": 1 - busy / host,
                   "tokens_s": T_BATCH * T_SEQ / host * 1e3,
                   "max_memory_gib": max(overall, step_peak) / 2**30,
                   "step_held_bytes": held, "step_peak_bytes": step_peak,
                   **work}
    print(f"T1 step at batch {T_BATCH} x {T_SEQ}: {host:.2f} ms host wall "
          f"(median of steps 2-{T_RUN}); the card busy {busy:.2f} ms over "
          f"{launches} launches (profiler), idle {1 - busy / host:.1%}; "
          f"{res['time']['tokens_s']:,.0f} tokens/s; bound "
          f"{work['bound_ms']:.2f} ms (float32 head {work['head_tflop']:.3f}"
          f" TFLOP {work['head_ms']:.2f} ms + bfloat16 body "
          f"{work['body_tflop']:.3f} TFLOP {work['body_ms']:.2f} ms + AdamW "
          f"{work['adamw_gb']:.2f} GB {work['adamw_ms']:.2f} ms; "
          f"{work['params']:,} parameters), {work['bound_ms'] / host:.1%} "
          f"of the host wall; peak: max_memory_allocated "
          f"{res['time']['max_memory_gib']:.3f} GiB; one step with "
          f"{held / 2**30:.3f} GiB held: {step_peak / 2**30:.3f} GiB "
          f"[{card}]")
    return res


def step_memory(fn) -> tuple:
    """(bytes allocated before, the most allocated during) one call of
    ``fn`` on the card, the peak reset just before it."""
    import torch

    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return held, torch.cuda.max_memory_allocated()


def t1_step_memory(dev) -> tuple:
    """T1's step alone, one state held: (bytes held, the most allocated
    during one step after a warm one), each less what the card held
    before T1's model and state were made (what earlier phases left)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.step import init_state, make_train_step

    gc.collect()
    base = torch.cuda.memory_allocated()
    cfg = get_config(T_ARCH)
    oc = t_opt()
    model = build_model(cfg, device=dev)
    state = init_state(model, oc, T_PARAM_SEED, device=dev)
    batch = t_batch(cfg.vocab_size, T_BATCH, T_SEQ, 0)
    step = make_train_step(model, oc, batch_tree(batch), device=dev).step_fn
    step(state, batch)
    held, peak = step_memory(lambda: step(state, batch))
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return held - base, peak - base, base


def phase_t2(dev, card: str, cfg=None) -> dict:
    """T2: deepseek-moe-16b at its published width, the depth cut to
    T2_LAYERS (the dense first layer and three MoE layers; ``cfg`` cuts
    it further for a rehearsal), with the reduced-memory optimizer state
    (bfloat16 m, qint8 v): card vs CPU at T2_CPU_LAYERS layers, the CPU
    replaying the card's routing; T2_RUN steps on a T2_BATCH batch (the
    aux loss positive and finite); the optimizer state through a
    checkpoint and back bitwise; the peak memory beside the reckoning."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_items
    from repro_torch.train.step import init_state

    cfg = cfg or dataclasses.replace(get_config(T2_ARCH),
                                     num_layers=T2_LAYERS)
    oc = t_opt(m_dtype=torch.bfloat16, v_dtype="qint8")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev)
    state = init_state(model, oc, T_PARAM_SEED, device=dev)
    res = {}
    res["cpu"] = train_vs_cpu("T2", cfg, state["params"], dev, card,
                              T2_CPU_LAYERS, T2_CPU_BATCH)[0]
    gc.collect()
    rows, seq = T2_BATCH
    t0 = time.perf_counter()
    state, hist = t_run(model, oc, dev, state, T2_RUN, rows, seq)
    run_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in tree_items(state["params"]))
    state_gb = {k: sum(t.numel() * t.element_size() for _, t in
                       tree_items(state["opt"][k])) / 1e9 for k in ("m", "v")}
    reckoned = (2 * n_params * 4) / 1e9 + sum(state_gb.values())
    with tempfile.TemporaryDirectory(prefix="phase_t2_") as d:
        t0 = time.perf_counter()
        ckpt.save({"opt": state["opt"]}, T2_RUN, d)
        back = ckpt.restore(d, T2_RUN, {"opt": state["opt"]}, device=dev)
        ckpt_s = time.perf_counter() - t0
    kept = same_tree(back["opt"], state["opt"]) and all(
        a.dtype == b.dtype for (_, a), (_, b) in
        zip(tree_items(back["opt"]), tree_items(state["opt"])))
    del back
    losses = [h["loss"] for h in hist]
    auxes = [h["aux"] for h in hist]
    res.update(losses=losses, aux=auxes, run_s=run_s, ckpt_s=ckpt_s,
               ckpt_bitwise=kept, params=n_params, state_gb=state_gb,
               reckoned_gb=reckoned,
               max_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"T2 {cfg.num_layers} layers (d_model {cfg.d_model}, "
          f"{cfg.moe.num_experts} routed experts top-{cfg.moe.top_k}, "
          f"{cfg.moe.num_shared} shared), {n_params:,} parameters, bfloat16 m"
          f" ({state_gb['m']:.2f} GB) and qint8 v ({state_gb['v']:.2f} GB): "
          f"{T2_RUN} steps at {rows} x {seq} in {run_s:.1f} s, losses "
          + ", ".join(f"{x:.5f}" for x in losses) + ", aux "
          + ", ".join(f"{x:.6f}" for x in auxes)
          + f"; m and v through a checkpoint and back bitwise: {kept} "
          f"({ckpt_s:.1f} s); reckoned state {reckoned:.2f} GB (float32 "
          f"parameters and gradients, m, v), " + memory_line("peak")
          + f" [{card}]")
    if not all(math.isfinite(x) for x in losses + auxes) or \
            min(auxes) <= 0:
        raise AssertionError(f"phase T2: losses {losses}, aux {auxes}")
    if not kept:
        raise AssertionError("phase T2: the optimizer state did not survive "
                             "a checkpoint bitwise")
    return res


def phase_t(dev, card: str, cfgs=None) -> dict:
    """Phase T: training, T1 and T2 (``cfgs`` {"T1": ..., "T2": ...} cut
    them for a rehearsal), each with the launch counts set to 0 just
    before and read just after: no kernel of the port may launch (the
    reference's training path reaches no Pallas kernel)."""
    import torch

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    out = {}
    for tag, fn in (("T1", phase_t1), ("T2", phase_t2)):
        res, launches = counted(lambda: fn(dev, card, (cfgs or {}).get(tag)))
        if any(n for entries in launches.values() for n in entries.values()):
            raise AssertionError(f"phase {tag} launched a kernel: "
                                 f"{launches}")
        out[tag] = res
        gc.collect()
        torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"phase T: {secs:.1f} s; no kernel of the port launched")
    out["seconds"] = secs
    return out


# phase U: autotuning on the card
U_REPS = 3                       # `core.autotune`'s timed reps a candidate


def search_launches(cands: list, per_call) -> int:
    """Launches of one search over ``cands``: a warm call, one sizing
    call and `U_REPS` timed calls each, ``per_call(c)`` launches a call."""
    return sum((2 + U_REPS) * per_call(c) for c in cands)


def tuned_case(tag: str, key0: str, default: int, plain, tuned,
               launches_of, kernel: str, entry: str, per_call,
               card: str, search_call=None) -> dict:
    """Run ``plain()`` and, from an empty cache, ``tuned()`` (each with
    the launch counts set to 0 just before), require the outputs bitwise
    equal and the tuned run's launches the untuned run's (at the winner)
    plus its search's; print the candidates' times with their spread, the
    default's, the winner and the search's host cost."""
    import torch

    from repro_torch.core import autotune

    want, got0 = counted(plain)
    autotune.clear_cache()
    out, got1 = counted(tuned)
    if isinstance(want, torch.Tensor):
        want, out = (want,), (out,)
    if isinstance(want, tuple):
        want, out = dict(enumerate(want)), dict(enumerate(out))
    for k in want:
        if not torch.equal(out[k], want[k]):
            raise AssertionError(f"phase U {tag}: tuned {k} differs from "
                                 f"the untuned run")
    log = autotune.search_log()
    keys = [k for k in log if k[0] == key0]
    if len(keys) != 1:
        raise AssertionError(f"phase U {tag}: searches {list(log)}")
    rec = log[keys[0]]
    if rec["clock"] != "cuda":
        raise AssertionError(f"phase U {tag}: timed on {rec['clock']}")
    base = launches_of(got0)
    # the tuned run launches at the winner where the untuned one did at
    # the default (the same count but for the resident loop's depth)
    expect = base - per_call(default) + per_call(rec["winner"]) + \
        search_launches(rec["candidates"], search_call or per_call)
    if launches_of(got1) != expect or got1[kernel][entry] < 1:
        raise AssertionError(f"phase U {tag}: {launches_of(got1)} launches, "
                             f"expected {base} + the search's = {expect}")
    times = dict(zip(rec["candidates"], rec["ms"]))
    if default not in times:
        raise AssertionError(f"phase U {tag}: default {default} not among "
                             f"{rec['candidates']}")
    res = {"key": list(keys[0]), "candidates": rec["candidates"],
           "ms": rec["ms"], "spread": rec["spread"], "default": default,
           "default_ms": times[default], "winner": rec["winner"],
           "winner_ms": times[rec["winner"]],
           "host_gaps": rec["host_gaps"],
           "search_ms": rec["search_ms"], "launches_untuned": base,
           "launches_tuned": launches_of(got1)}
    print(f"phase U {tag}: " + ", ".join(
        f"{c} {ms:.4f} ms (+{100 * sp:.0f}%)" for c, ms, sp in
        zip(rec["candidates"], rec["ms"], rec["spread"]))
        + f"; default {default} {times[default]:.4f} ms, winner "
        f"{rec['winner']} {times[rec['winner']]:.4f} ms "
        f"({times[default] / times[rec['winner']]:.3f}x the default; "
        f"{'host gaps in' if rec['host_gaps'] else 'device time alone'}), "
        f"search {rec['search_ms']:.1f} ms of host; tuned == untuned "
        f"bitwise, {base} -> {launches_of(got1)} {kernel} launches [{card}]")
    return res


def phase_u(dev, card: str, app, asr_app, sig, audio) -> dict:
    """Phase U: `core.autotune` on the card at the main path's shapes.
    The biosignal day as `BiosignalStream` at batch_windows 8 and 512,
    kernel- and host-framed, and as one `graph_pipeline_stream` call; the
    ASR hour at batch_windows 32 and in one call; `ResidentStream` on the
    day at B=8 with ``ResidentConfig(autotune=True)``; the FIR and the
    FFT at `pipeline_staged`'s shapes. Each tuned output bitwise its
    untuned run, each search timed with CUDA events."""
    from repro_torch.core.autotune import candidate_ring_depths
    from repro_torch.kernels.fft.kernel import default_block_rows as fft_rb
    from repro_torch.kernels.fft.ops import fft
    from repro_torch.kernels.fir.kernel import default_block_rows as fir_rb
    from repro_torch.kernels.fir.ops import fir
    from repro_torch.kernels.pipeline.asr import ASR_BLOCK_FRAMES
    from repro_torch.kernels.pipeline.graph import stream_frame_count
    from repro_torch.kernels.pipeline.kernel import BIOSIGNAL_BLOCK_FRAMES
    from repro_torch.kernels.pipeline.ops import graph_pipeline_stream
    from repro_torch.serve.resident import (DEFAULT_RING_DEPTH,
                                            ResidentConfig, ResidentStream)
    from repro_torch.serve.stream import (BiosignalStream, StreamConfig,
                                          frame_signal)

    t_start = time.perf_counter()
    feat = ("features", "margin", "class")
    n = stream_frame_count(sig.shape[0], WINDOW, HOP)
    bio = lambda e: lambda got: got["biosignal_graph"][e]   # noqa: E731
    one = lambda c: 1                                       # noqa: E731
    out = {}
    for B in (8, 512):
        for framing, entry, key0 in (("kernel", "stream",
                                      "biosignal_pipeline_stream"),
                                     ("host", "frames", "biosignal_pipeline")):
            cfg = StreamConfig(window=WINDOW, hop=HOP, batch_windows=B,
                               framing=framing, outputs=feat)
            tcfg = StreamConfig(window=WINDOW, hop=HOP, batch_windows=B,
                                framing=framing, outputs=feat, autotune=True)
            out[f"day B={B} {framing}"] = tuned_case(
                f"day B={B} {framing}-framed", key0, BIOSIGNAL_BLOCK_FRAMES,
                lambda: BiosignalStream(app, cfg).process(sig),
                lambda: BiosignalStream(app, tcfg).process(sig),
                bio(entry), "biosignal_graph", entry, one, card)
    out["day one call"] = tuned_case(
        "day in one call", "biosignal_pipeline_stream",
        BIOSIGNAL_BLOCK_FRAMES,
        lambda: graph_pipeline_stream("biosignal", app, sig, window=WINDOW,
                                      hop=HOP, outputs=feat),
        lambda: graph_pipeline_stream("biosignal", app, sig, window=WINDOW,
                                      hop=HOP, outputs=feat, autotune=True),
        bio("stream"), "biosignal_graph", "stream", one, card)
    W, H, mel = ASR_WINDOW, ASR_HOP, ("logmel",)
    acfg = dict(window=W, hop=H, batch_windows=32, graph="asr", outputs=mel)
    asr = lambda got: got["asr_graph"]["stream"]            # noqa: E731
    out["hour B=32"] = tuned_case(
        "ASR hour B=32", "asr_pipeline_stream", ASR_BLOCK_FRAMES,
        lambda: BiosignalStream(asr_app, StreamConfig(**acfg)).process(audio),
        lambda: BiosignalStream(asr_app, StreamConfig(
            autotune=True, **acfg)).process(audio),
        asr, "asr_graph", "stream", one, card)
    out["hour one call"] = tuned_case(
        "ASR hour in one call", "asr_pipeline_stream", ASR_BLOCK_FRAMES,
        lambda: graph_pipeline_stream("asr", asr_app, audio, window=W,
                                      hop=H, outputs=mel),
        lambda: graph_pipeline_stream("asr", asr_app, audio, window=W,
                                      hop=H, outputs=mel, autotune=True),
        asr, "asr_graph", "stream", one, card)
    rcfg = StreamConfig(window=WINDOW, hop=HOP, batch_windows=8,
                        outputs=feat)
    n_batches = -(-n // 8)
    rs_plain = ResidentStream(app, rcfg, ResidentConfig(drain_interval=4))
    rs_tuned = ResidentStream(app, rcfg, ResidentConfig(drain_interval=4,
                                                        autotune=True))
    out["resident B=8"] = tuned_case(
        "resident day B=8 ring depth", "resident_ring", DEFAULT_RING_DEPTH,
        lambda: rs_plain.process(sig), lambda: rs_tuned.process(sig),
        bio("ring"), "biosignal_graph", "ring",
        lambda rd: -(-n_batches // rd), card,
        # the search runs on zeros of (n_batches * 8 + 7) frames, the
        # reference's length formula: one batch more than the signal's
        search_call=lambda rd: -(-(n_batches + 1) // rd))
    if rs_tuned.last_drains[-1] != n:
        raise AssertionError(f"tuned resident drained "
                             f"{rs_tuned.last_drains[-1]} != {n}")
    if out["resident B=8"]["candidates"] != candidate_ring_depths(n_batches):
        raise AssertionError("resident candidates")
    day_frames = frame_signal(sig, WINDOW, HOP)
    seg = day_frames[:, :FFT].contiguous()
    zr, zi = seg[:, 0::2].contiguous(), seg[:, 1::2].contiguous()
    out["fir staged"] = tuned_case(
        f"FIR pipeline_staged ({n} x {WINDOW}, 11 taps)", "fir",
        fir_rb(WINDOW), lambda: fir(day_frames, app.fir_taps),
        lambda: fir(day_frames, app.fir_taps, autotune=True),
        lambda got: got["fir"]["rows"], "fir", "rows", one, card)
    out["fft staged"] = tuned_case(
        f"FFT pipeline_staged ({n} x {FFT // 2})", "fft", fft_rb(FFT // 2),
        lambda: fft(zr, zi), lambda: fft(zr, zi, autotune=True),
        lambda got: got["fft"]["rows"], "fft", "rows", one, card)
    del day_frames, seg, zr, zi
    secs = time.perf_counter() - t_start
    print(f"phase U: {secs:.1f} s; {len(out)} searches on the card, every "
          f"tuned output bitwise its untuned run")
    out["seconds"] = secs
    return out


# what phase E holds the card's SVM fit to against the CPU's: the 12x12
# float32 normal matrix has a condition number of ~8e8, and the port's
# and the reference's CPU fits part by up to 5e-3 of max |w| (the same
# bound as tests/test_torch_core.py's SVM_FIT_RTOL)
E_FIT_RTOL = 1e-2


def phase_e(dev, card: str) -> dict:
    """Phase E: the paper's application end to end on the card
    (`launch.biosignal_app.run`), its readings printed and checked: the
    example's margin bounds, the fit against the same fit on the CPU,
    the holdout classes, the simulator's cycles and predicted class
    against a run with the CPU's fit, and the biosignal graph kernel's
    launches. The simulator's program does not depend on the weights'
    values, so its cycles show only that it is deterministic; its class
    (the sign of the margin from ``w`` and ``b``) is what checks the
    card's fit."""
    from repro_torch.launch import biosignal_app as bapp

    t0 = time.perf_counter()
    r, got = counted(lambda: bapp.run(dev))
    for line in bapp.report(r):
        print(f"phase E {line} [{card}]")
    if not r["staged_err"] <= bapp.STAGED_TOL or \
            not r["column_err"] <= bapp.COLUMN_TOL:
        raise AssertionError(f"phase E margins: staged {r['staged_err']}, "
                             f"4 columns {r['column_err']}")
    cpu = bapp.fit_svm("cpu")
    w_err = float((r["w"].cpu() - cpu["w"]).abs().max())
    b_err = float((r["b"].cpu() - cpu["b"]).abs().max())
    w_lim = E_FIT_RTOL * float(cpu["w"].abs().max())
    b_lim = E_FIT_RTOL * float(cpu["b"].abs().max())
    if w_err > w_lim or b_err > b_lim:
        raise AssertionError(f"phase E fit: |w| {w_err} > {w_lim} or |b| "
                             f"{b_err} > {b_lim}")
    if not bool((r["holdout_pred"].cpu() == cpu["pred"]).all()):
        raise AssertionError("phase E holdout classes differ from the CPU")
    sim_cpu = bapp.archsim_window(cpu["signal"][0].numpy() * 0.5,
                                  cpu["w"].numpy(), cpu["b"].numpy())
    if sim_cpu["cycles"] != r["archsim"]["cycles"] or \
            sim_cpu["prediction"] != r["archsim"]["prediction"]:
        raise AssertionError(
            f"phase E simulator: cycles {r['archsim']['cycles']}, class "
            f"{r['archsim']['prediction']} against {sim_cpu['cycles']}, "
            f"{sim_cpu['prediction']} with the CPU's fit")
    launches = {e: got["biosignal_graph"][e] for e in ("stream", "frames")}
    if not launches["stream"] or not launches["frames"]:
        raise AssertionError(f"phase E launches {got}")
    secs = time.perf_counter() - t0
    print(f"phase E: {secs:.1f} s; fit vs the CPU max |w| {w_err:.3e}, "
          f"|b| {b_err:.3e} (limits {w_lim:.3e}, {b_lim:.3e}), holdout "
          f"classes equal, the simulator's cycles and class equal with "
          f"the CPU's fit; biosignal_graph "
          f"launches {launches}")
    return {"seconds": secs, "windows": r["windows"],
            "windows_per_s": r["windows_per_s"],
            "host_windows_per_s": r["host_windows_per_s"],
            "column_err": r["column_err"], "staged_err": r["staged_err"],
            "accuracy": r["accuracy"], "w_err": w_err, "b_err": b_err,
            "archsim": r["archsim"], "autotune": r["autotune"],
            "launches": launches}


D_DTYPES = ("bfloat16", "float16")
I_DTYPES = ("int16", "int32", "int8", "uint8")
B_DTYPES = ("int8", "uint8")   # through the user entries, day and hour
# the uint8 biosignal run against the plain version: the band sums reduce
# in another order over values up to 255 about uint8's mid-scale offset of
# 127.5, which the segment mean takes out (1.27e-5 relative read on the
# card, hop 513, past TOL's 1e-5): features and margin within 1e-4
# relative (class, filtered and the interval features stay exact). int8,
# centred on -0.5, is held to TOL. The plain features rounded to float16
# must read above it: `byte_tol_control` measures that on every run.
BYTE_TOL = {"features": (1e-4, 1e-4), "margin": (1e-3, 1e-4)}
I_FRAMES = 512          # the integer runs' frames at each entry


def full_scale(x, dtype):
    """``x`` (a float signal) plus a square wave of period 74 samples,
    scaled to twice the integer ``dtype``'s range about its middle and
    saturated into it: the graphs' filters overshoot past the range at
    the square's edges, so ``filtered`` saturates."""
    import torch

    from repro_torch.kernels.pipeline.graph import cast_output

    info = torch.iinfo(dtype)
    mid, half = (info.max + info.min) / 2.0, (info.max - info.min) / 2.0
    square = torch.where(torch.arange(x.numel(), device=x.device) // 37 % 2
                         == 0, 0.5, -0.5)
    return cast_output(mid + (0.5 * x / x.abs().max() + square) * 2.0
                       * half, dtype)


def oracle_units(name: str, logmel, asr_app, x, window: int,
                 hop: int) -> float:
    """The largest |logmel - oracle| over ``x``'s frames in units of the
    float64 oracle's per-element limit (`asr_oracle64`); raises past 1."""
    import numpy as np

    from repro_torch.kernels.pipeline.asr import asr_oracle64

    want, limit = asr_oracle64(asr_app, x.cpu(), window=window, hop=hop)
    got = logmel.cpu().double().numpy()
    units = float((np.abs(got - want) / limit).max())
    if not units < 1.0:
        raise AssertionError(f"{name}: logmel {units:.3f} x the float64 "
                             f"oracle's limit")
    return units


def check_dtype_run(name: str, got: dict, want: dict, tol=None) -> float:
    """Raise unless a 16-bit or integer run's outputs ``got`` match the
    plain version's ``want``: class exact, filtered bitwise in the
    signal's dtype, features and margin within ``tol`` (default `TOL`),
    logmel within `ASR_LOGMEL_TOL`; returns the largest float
    difference."""
    import torch

    if sorted(got) != sorted(want):
        raise AssertionError(f"{name}: keys {sorted(got)} != {sorted(want)}")
    if "filtered" in want and not torch.equal(got["filtered"],
                                              want["filtered"]):
        raise AssertionError(f"{name}/filtered: not bitwise the plain "
                             f"version's")
    if "logmel" in want:
        return check_asr(name, got, want)
    rest = [k for k in want if k != "filtered"]
    return check_close(name, {k: got[k] for k in rest},
                       {k: want[k] for k in rest}, tol)


def widened_reference(run32, dtype) -> dict:
    """The float32 kernel's outputs on the widened signal, ``filtered``
    rounded to ``dtype``: what every 16-bit run must give bitwise (the
    kernels widen at the load and compute in float32 after it)."""
    return {k: v.to(dtype) if k == "filtered" else v
            for k, v in run32.items()}


def phase_d(dev, card: str, app, sig, asr_app, audio, day_steps: int = 2048,
            hour_steps: int = 8192) -> dict:
    """Phase D: bfloat16, float16, int16, int32, int8, uint8 and int64
    signals through both graph kernels.

    For each dtype, the biosignal day (`sig` narrowed) at B=8 raw stream
    and host-framed, resident (ring depth 4), in one call and over 4
    columns, and the ASR hour at B=32 and in one call, each with every
    output and its launches counted: every run bitwise the float32 kernel
    on the widened signal (``filtered`` rounded to the dtype), and the
    one-call output against the plain version on the 16-bit signal in
    slices (class exact, ``filtered`` bitwise). int16, int32, int8 and
    uint8 signals near full scale (`full_scale`: the filters pass the
    range, so ``filtered`` saturates), `I_FRAMES` frames of each graph at
    the stream, frames and ring entries: each bitwise the float32 kernel
    on the widened signal (``filtered`` cast as the reference's astype)
    and against the plain version (class exact, ``filtered`` bitwise,
    features and margin within `TOL`, uint8's within `BYTE_TOL`). An
    int64 signal of scale 3e9 at the same entries: int32 ``filtered``,
    bitwise the int32 kernel on the signal narrowed to its low 32 bits
    (the reference's staging), and against the plain version on the
    narrowed signal as above.
    The 8-bit ones (`B_DTYPES`) also over the whole day (B=8) and hour
    (B=32) through `BiosignalStream`, its host-framed path and
    `ResidentStream`, each bitwise the float32 kernel on the widened
    signal, its launches counted. Any other dtype (uint16, float64 at the
    launcher) raises before a launch.
    Then each entry's device time at the main path's dispatch and over the
    whole signal with ``filtered``, per dtype beside float32's and the
    bytes bound."""
    import torch

    from repro_torch.kernels import _cuda
    from repro_torch.kernels.pipeline import cuda as pcuda
    from repro_torch.kernels.pipeline.graph import (
        cast_output, get_graph_factory, graph_frames_call, graph_frames_plain,
        graph_ring_call, graph_ring_plain, graph_stream_call,
        graph_stream_plain, ring_chunk_samples, stream_frame_count)
    from repro_torch.kernels.pipeline.kernel import OUTPUTS
    from repro_torch.kernels.pipeline.ops import (app_pipeline_stream,
                                                  graph_pipeline_stream)
    from repro_torch.serve.resident import ResidentConfig, ResidentStream
    from repro_torch.serve.stream import (BiosignalStream, StreamConfig,
                                          frame_signal)

    t_phase = time.perf_counter()
    graph, operands = get_graph_factory("biosignal")(app)
    asr_graph, asr_ops = get_graph_factory("asr")(asr_app)
    n = stream_frame_count(sig.shape[0], WINDOW, HOP)
    na = stream_frame_count(audio.shape[0], ASR_WINDOW, ASR_HOP)
    both = ("filtered", "logmel")
    report: dict = {"runs": {}, "times": {}}
    # any other dtype raises at the launcher, before a launch
    framing = dict(entry="stream", window=WINDOW, n_frames=1,
                   frame_stride=HOP, n_slots=1, slot_stride=0, taps=None,
                   fft_size=FFT, block_frames=1, out={})
    launchers = {
        "biosignal": lambda t: pcuda.launch_biosignal_graph(
            t, twiddle_re=None, twiddle_im=None, untangle=None, svm_w=None,
            svm_b=None, bands=(1,) * 7, prominence=0.3, min_distance=15,
            **framing),
        "asr": lambda t: pcuda.launch_asr_graph(
            t, hann=None, twiddles=None, untangle=None, spans=None,
            **framing)}
    for bad in (torch.uint16, torch.float64):
        for gname, launcher in launchers.items():
            _cuda.reset_launches()
            try:
                launcher(sig[:WINDOW].to(bad))
            except ValueError:
                pass
            else:
                raise AssertionError(f"the {gname} launcher took {bad}")
            if any(v for e in _cuda.LAUNCHES.values() for v in e.values()):
                raise AssertionError(f"{gname} {bad}: a kernel launched")
    print("phase D: the graph launchers refuse uint16 and float64 signals "
          "before any launch (the entries narrow float64 first)")
    for dname in D_DTYPES:
        dtype = getattr(torch, dname)
        # ---- the biosignal day
        x = sig.to(dtype)
        want = widened_reference(graph_stream_call(
            x.float(), operands, graph=graph, window=WINDOW, hop=HOP), dtype)
        runs = [
            ("stream B=8", lambda: BiosignalStream(app, StreamConfig(
                window=WINDOW, hop=HOP, batch_windows=8)).process(x),
             {("biosignal_graph", "stream"): -(-n // 8)}),
            ("host-framed B=8", lambda: BiosignalStream(app, StreamConfig(
                window=WINDOW, hop=HOP, batch_windows=8,
                framing="host")).process(x),
             {("biosignal_graph", "frames"): -(-n // 8)}),
            ("resident B=8", lambda: ResidentStream(app, StreamConfig(
                window=WINDOW, hop=HOP, batch_windows=8), ResidentConfig(
                ring_depth=4, drain_interval=4)).process(x),
             {("biosignal_graph", "ring"): -(-n // 32)}),
            ("one call", lambda: app_pipeline_stream(app, x, window=WINDOW,
                                                     hop=HOP),
             {("biosignal_graph", "stream"): 1}),
            ("4 columns", lambda: app_pipeline_stream(
                app, x, window=WINDOW, hop=HOP, n_columns=4),
             {("biosignal_graph", "stream"): 4}),
        ]
        for tag, fn, launches in runs:
            out, got = counted(fn)
            expect_launches(f"D {dname} {tag}", got, launches)
            check_equal(f"D {dname} biosignal {tag} == float32 on the "
                        f"widened day", out, want)
            report["runs"][f"{dname} biosignal {tag}"] = {
                "launches": {f"{k}.{e}": v for (k, e), v in launches.items()}}
        worst = 0.0
        for f0 in range(0, n, day_steps):
            f1 = min(n, f0 + day_steps)
            plain = graph_stream_plain(x[f0 * HOP: (f1 - 1) * HOP + WINDOW],
                                       operands, graph=graph, window=WINDOW,
                                       hop=HOP)
            worst = max(worst, check_dtype_run(
                f"D {dname} day frames {f0}:{f1}",
                {k: v[f0:f1] for k, v in want.items()}, plain))
        report["runs"][f"{dname} biosignal max_abs_err"] = worst
        print(f"phase D {dname} biosignal day ({n} frames): stream B=8, "
              f"host-framed B=8, resident, one call and 4 columns bitwise "
              f"the float32 kernel on the widened day (filtered rounded); "
              f"vs plain: class exact, filtered bitwise, max |diff| "
              f"{worst:.3e}")
        del want, x
        # ---- the ASR hour
        xa = audio.to(dtype)
        want = widened_reference(graph_stream_call(
            xa.float(), asr_ops, graph=asr_graph, window=ASR_WINDOW,
            hop=ASR_HOP, outputs=both), dtype)
        runs = [
            ("stream B=32", lambda: BiosignalStream(asr_app, StreamConfig(
                window=ASR_WINDOW, hop=ASR_HOP, batch_windows=32,
                graph="asr", outputs=both)).process(xa),
             {("asr_graph", "stream"): -(-na // 32)}),
            ("one call", lambda: graph_pipeline_stream(
                "asr", asr_app, xa, window=ASR_WINDOW, hop=ASR_HOP,
                outputs=both), {("asr_graph", "stream"): 1}),
        ]
        for tag, fn, launches in runs:
            out, got = counted(fn)
            expect_launches(f"D {dname} asr {tag}", got, launches)
            check_equal(f"D {dname} asr {tag} == float32 on the widened "
                        f"hour", out, want)
            report["runs"][f"{dname} asr {tag}"] = {
                "launches": {f"{k}.{e}": v for (k, e), v in launches.items()}}
            del out
        worst = 0.0
        for f0 in range(0, na, hour_steps):
            f1 = min(na, f0 + hour_steps)
            plain = graph_stream_plain(
                xa[f0 * ASR_HOP: (f1 - 1) * ASR_HOP + ASR_WINDOW], asr_ops,
                graph=asr_graph, window=ASR_WINDOW, hop=ASR_HOP,
                outputs=both)
            worst = max(worst, check_dtype_run(
                f"D {dname} hour frames {f0}:{f1}",
                {k: v[f0:f1] for k, v in want.items()}, plain))
        report["runs"][f"{dname} asr max_abs_err"] = worst
        print(f"phase D {dname} ASR hour ({na} frames): stream B=32 and one "
              f"call bitwise the float32 kernel on the widened hour; vs "
              f"plain: filtered bitwise, logmel max |diff| {worst:.3e}")
        del want, xa
    # ---- integer signals near full scale at the three entries of both
    # graphs
    for dname in I_DTYPES:
        dtype = getattr(torch, dname)
        info = torch.iinfo(dtype)
        for gname, g, g_ops, w, h, base in (
                ("biosignal", graph, operands, WINDOW, HOP, sig),
                ("asr", asr_graph, asr_ops, ASR_WINDOW, ASR_HOP, audio)):
            x = full_scale(base[: (I_FRAMES - 1) * h + w], dtype)
            wide = graph_stream_call(x.float(), g_ops, graph=g, window=w,
                                     hop=h)
            # both rails, but the ASR graph's pre-emphasis takes out an
            # unsigned signal's mid-scale offset: only the low rail there
            above = bool(wide["filtered"].max() > info.max)
            below = bool(wide["filtered"].min() < info.min)
            if not (below and (above or (gname == "asr"
                                         and not dtype.is_signed))):
                raise AssertionError(f"D {dname} {gname}: the filter stays "
                                     f"inside the range (above {above}, "
                                     f"below {below})")
            want = {k: cast_output(v, dtype) if k == "filtered" else v
                    for k, v in wide.items()}
            frames = frame_signal(x, w, h)
            bw = 8
            span = ring_chunk_samples(w, h, bw)
            ring = x[: (I_FRAMES // bw - 1) * bw * h + span].as_strided(
                (I_FRAMES // bw, span), (bw * h, 1))
            kw = dict(graph=g)
            runs = {
                "stream": (lambda: graph_stream_call(
                    x, g_ops, window=w, hop=h, **kw),
                    lambda: graph_stream_plain(x, g_ops, window=w, hop=h,
                                               **kw)),
                "frames": (lambda: graph_frames_call(frames, g_ops, **kw),
                           lambda: graph_frames_plain(frames, g_ops, **kw)),
                "ring": (lambda: graph_ring_call(
                    ring, g_ops, window=w, hop=h, **kw),
                    lambda: graph_ring_plain(ring, g_ops, window=w, hop=h,
                                             **kw))}
            byte_tol = BYTE_TOL if dtype == torch.uint8 else None
            worst, read, byte_read = 0.0, 0.0, 0.0
            for entry, (fn, plain_fn) in runs.items():
                out, got = counted(fn)
                expect_launches(f"D {dname} {gname} {entry}", got,
                                {(f"{gname}_graph", entry): 1})
                flat = {k: v.reshape((I_FRAMES,) + v.shape[2:])
                        if entry == "ring" else v for k, v in out.items()}
                if flat["filtered"].dtype != dtype:
                    raise AssertionError(f"D {dname} {gname} {entry}: "
                                         f"filtered {flat['filtered'].dtype}")
                check_equal(f"D {dname} {gname} {entry} == float32 on the "
                            f"widened signal", flat, want)
                plain = {k: v.reshape((I_FRAMES,) + v.shape[2:])
                         if entry == "ring" else v
                         for k, v in plain_fn().items()}
                worst = max(worst, check_dtype_run(
                    f"D {dname} {gname} {entry} vs plain", flat, plain,
                    byte_tol))
                if gname == "biosignal":
                    read = max(read, tol_units(flat, plain))
                    byte_read = max(byte_read,
                                    tol_units(flat, plain, BYTE_TOL))
                report["runs"][f"{dname} {gname} {entry}"] = {
                    "launches": {f"{gname}_graph.{entry}": 1}}
            saturated = int((want["filtered"] == info.max).sum() +
                            (want["filtered"] == info.min).sum())
            report["runs"][f"{dname} {gname} max_abs_err"] = worst
            report["runs"][f"{dname} {gname} saturated"] = saturated
            note = ""
            if gname == "biosignal":
                # features and margin in units of TOL's limit, and for
                # uint8 of BYTE_TOL's with its float16 control
                report["runs"][f"{dname} biosignal TOL units"] = read
                note = f"; features/margin at {read:.4f} of TOL's limit"
                if byte_tol:
                    control = byte_tol_control(plain)
                    report["runs"][f"{dname} biosignal BYTE_TOL units"] = {
                        "kernel": byte_read, "float16 control": control}
                    note += (f", {byte_read:.4f} of BYTE_TOL's (the plain"
                               f" features rounded to float16: "
                               f"{control:.4f})")
            else:
                # logmel at PCM scale against the float64 oracle's limit
                # (ASR_LOGMEL_TOL is calibrated on audio in [-1, 1])
                units = {who: oracle_units(name_run, v, asr_app, x, w, h)
                         for who, name_run, v in (
                             ("kernel", f"D {dname} asr kernel",
                              want["logmel"]),
                             ("plain", f"D {dname} asr plain",
                              graph_stream_plain(x, g_ops, window=w, hop=h,
                                                 **kw)["logmel"]))}
                report["runs"][f"{dname} asr oracle units"] = units
                note = ("; logmel vs the float64 oracle, in units of its "
                          "limit: kernel {kernel:.4f}, plain {plain:.4f}"
                          ).format(**units)
            print(f"phase D {dname} {gname} ({I_FRAMES} frames near full "
                  f"scale, {saturated} filtered samples saturated): stream, "
                  f"frames and ring bitwise the float32 kernel on the "
                  f"widened signal (filtered cast as astype); vs plain: "
                  f"class exact, filtered bitwise, max |diff| {worst:.3e}"
                  + note)
            del x, wide, want, frames, ring
    # ---- int64 signals past int32's range at the three entries of both
    # graphs: narrowed to their low 32 bits where they are staged (the
    # reference's jnp.asarray with x64 off), then the int32 kernel
    for gname, g, g_ops, w, h, base in (
            ("biosignal", graph, operands, WINDOW, HOP, sig),
            ("asr", asr_graph, asr_ops, ASR_WINDOW, ASR_HOP, audio)):
        seg = base[: (I_FRAMES - 1) * h + w].double()
        x = (seg / seg.abs().max() * 3e9).round().long()
        x32 = x.to(torch.int32)
        bw = 8
        span = ring_chunk_samples(w, h, bw)
        kw = dict(graph=g)
        worst = 0.0
        for entry, call, plain_call, shaped in (
                ("stream",
                 lambda s: graph_stream_call(s, g_ops, window=w, hop=h, **kw),
                 lambda s: graph_stream_plain(s, g_ops, window=w, hop=h,
                                              **kw),
                 lambda s: s),
                ("frames", lambda f: graph_frames_call(f, g_ops, **kw),
                 lambda f: graph_frames_plain(f, g_ops, **kw),
                 lambda s: frame_signal(s, w, h)),
                ("ring",
                 lambda r: graph_ring_call(r, g_ops, window=w, hop=h, **kw),
                 lambda r: graph_ring_plain(r, g_ops, window=w, hop=h, **kw),
                 lambda s: s[: (I_FRAMES // bw - 1) * bw * h + span]
                 .as_strided((I_FRAMES // bw, span), (bw * h, 1)))):
            out, got = counted(lambda: call(shaped(x)))
            expect_launches(f"D int64 {gname} {entry}", got,
                            {(f"{gname}_graph", entry): 1})
            if out["filtered"].dtype != torch.int32:
                raise AssertionError(f"D int64 {gname} {entry}: filtered "
                                     f"{out['filtered'].dtype}")
            check_equal(f"D int64 {gname} {entry} == int32 on the narrowed "
                        f"signal", out, call(shaped(x32)))
            worst = max(worst, check_dtype_run(
                f"D int64 {gname} {entry} vs plain", out,
                plain_call(shaped(x32))))
            report["runs"][f"int64 {gname} {entry}"] = {
                "launches": {f"{gname}_graph.{entry}": 1}}
        report["runs"][f"int64 {gname} max_abs_err"] = worst
        print(f"phase D int64 {gname} ({I_FRAMES} frames of scale 3e9, past "
              f"int32's range): stream, frames and ring give int32 filtered, "
              f"bitwise the int32 kernel on the narrowed signal; vs plain: "
              f"class exact, filtered bitwise, max |diff| {worst:.3e}")
        del x, x32
    # ---- 8-bit signals near full scale through the user entries: the day
    # and the hour by the stream, the host-framed stream and the resident
    # ring, each bitwise the float32 kernel on the widened signal
    for dname in B_DTYPES:
        dtype = getattr(torch, dname)
        info = torch.iinfo(dtype)
        for gname, a, g, g_ops, w, h, base, B, extra in (
                ("biosignal", app, graph, operands, WINDOW, HOP, sig, 8, {}),
                ("asr", asr_app, asr_graph, asr_ops, ASR_WINDOW, ASR_HOP,
                 audio, 32, {"graph": "asr", "outputs": both})):
            x = full_scale(base, dtype)
            nf = stream_frame_count(x.shape[0], w, h)
            want = graph_stream_call(x.float(), g_ops, graph=g, window=w,
                                     hop=h, outputs=extra.get(
                                         "outputs", OUTPUTS))
            want = {k: cast_output(v, dtype) if k == "filtered" else v
                    for k, v in want.items()}
            kname = f"{gname}_graph"
            runs = [
                ("stream", lambda: BiosignalStream(a, StreamConfig(
                    window=w, hop=h, batch_windows=B, **extra)).process(x),
                 {(kname, "stream"): -(-nf // B)}),
                ("host-framed", lambda: BiosignalStream(a, StreamConfig(
                    window=w, hop=h, batch_windows=B, framing="host",
                    **extra)).process(x), {(kname, "frames"): -(-nf // B)}),
                ("resident", lambda: ResidentStream(a, StreamConfig(
                    window=w, hop=h, batch_windows=B, **extra),
                    ResidentConfig(ring_depth=4, drain_interval=4)).process(
                    x), {(kname, "ring"): -(-nf // (4 * B))})]
            for tag, fn, launches in runs:
                out, got = counted(fn)
                expect_launches(f"D {dname} {gname} {tag}", got, launches)
                check_equal(f"D {dname} {gname} {tag} B={B} == float32 on "
                            f"the widened signal", out, want)
                report["runs"][f"{dname} {gname} {tag} B={B}"] = {
                    "launches": {f"{k}.{e}": v
                                 for (k, e), v in launches.items()}}
                del out
            saturated = int((want["filtered"] == info.max).sum() +
                            (want["filtered"] == info.min).sum())
            print(f"phase D {dname} {gname} ({nf} frames near full scale, "
                  f"{saturated} filtered samples saturated): stream, "
                  f"host-framed and resident at B={B} bitwise the float32 "
                  f"kernel on the widened signal")
            del x, want
    # ---- device times: each entry at the main path's dispatch, and the
    # whole signal with `filtered`, per dtype beside float32's and the
    # bytes bound of that dtype (the integer signals near full scale)
    feat = ("features", "margin", "class")
    span8 = ring_chunk_samples(WINDOW, HOP, 8)
    span32 = ring_chunk_samples(ASR_WINDOW, ASR_HOP, 32)
    mel_nnz = int((asr_app.mel_weights != 0).sum())
    for dname in ("float32",) + D_DTYPES + I_DTYPES:
        dtype = getattr(torch, dname)
        elem = torch.empty((), dtype=dtype).element_size()
        x, xa = (sig.to(dtype), audio.to(dtype)) if dtype.is_floating_point \
            else (full_scale(sig, dtype), full_scale(audio, dtype))
        # this signal's candidate and extremum counts, for the bounds
        c, e = extremum_counts(graph_stream_call(
            x, operands, graph=graph, window=WINDOW, hop=HOP,
            outputs=("filtered",))["filtered"].float())
        cand, ext = c.cumsum(0).tolist(), e.cumsum(0).tolist()
        del c, e
        chunk8, chunk32 = x[:span8], xa[:span32]
        frames8 = frame_signal(chunk8, WINDOW, HOP)
        frames32 = frame_signal(chunk32, ASR_WINDOW, ASR_HOP)
        ring8 = x[: 3 * 8 * HOP + span8].as_strided((4, span8), (8 * HOP, 1))
        ring32 = xa[: 3 * 32 * ASR_HOP + span32].as_strided(
            (4, span32), (32 * ASR_HOP, 1))
        bkw = dict(graph=graph, outputs=feat)
        akw = dict(graph=asr_graph, outputs=("logmel",))
        cases = {
            "biosignal stream B=8": (
                lambda: graph_stream_call(chunk8, operands, window=WINDOW,
                                          hop=HOP, **bkw),
                graph_work(8, span8, feat, cand[7], ext[7], elem=elem)),
            "biosignal frames B=8": (
                lambda: graph_frames_call(frames8, operands, **bkw),
                graph_work(8, frames8.numel(), feat, cand[7], ext[7],
                           elem=elem)),
            "biosignal ring 4 x B=8": (
                lambda: graph_ring_call(ring8, operands, window=WINDOW,
                                        hop=HOP, **bkw),
                graph_work(32, 3 * 8 * HOP + span8, feat, cand[31], ext[31],
                           elem=elem)),
            "biosignal day +filtered": (
                lambda: graph_stream_call(x, operands, graph=graph,
                                          window=WINDOW, hop=HOP),
                graph_work(n, x.numel(), OUTPUTS, cand[-1], ext[-1],
                           elem=elem)),
            "asr stream B=32": (
                lambda: graph_stream_call(chunk32, asr_ops, window=ASR_WINDOW,
                                          hop=ASR_HOP, **akw),
                asr_graph_work(32, span32, ("logmel",), mel_nnz, elem=elem)),
            "asr frames B=32": (
                lambda: graph_frames_call(frames32, asr_ops, **akw),
                asr_graph_work(32, frames32.numel(), ("logmel",), mel_nnz,
                               elem=elem)),
            "asr ring 4 x B=32": (
                lambda: graph_ring_call(ring32, asr_ops, window=ASR_WINDOW,
                                        hop=ASR_HOP, **akw),
                asr_graph_work(128, 3 * 32 * ASR_HOP + span32, ("logmel",),
                               mel_nnz, elem=elem)),
            "asr hour +filtered": (
                lambda: graph_stream_call(xa, asr_ops, graph=asr_graph,
                                          window=ASR_WINDOW, hop=ASR_HOP,
                                          outputs=both),
                asr_graph_work(na, xa.numel(), both, mel_nnz, elem=elem)),
        }
        for label, (fn, work) in cases.items():
            bms, by = bound_ms(*work)
            report["times"].setdefault(label, {})[dname] = {
                "ms": event_ms(fn, 10 if "+filtered" in label else 200),
                "bound_ms": bms, "bound_by": by}
        del x, xa
    for label, row in report["times"].items():
        print(f"time D {label}: " + "; ".join(
            f"{d} {r['ms']:.5f} ms (bound {r['bound_ms']:.6f} ms, "
            f"{r['bound_by']})" for d, r in row.items()) + f" [{card}]")
    report["wall_s"] = time.perf_counter() - t_phase
    print(f"phase D: {report['wall_s']:.1f} s wall")
    return report


K_FFT_N = 1 << 20       # the spectrum of a 17-minute record at 1 kHz
K_FFT_SMALL = 1 << 14   # the smallest four-step row
K_FFT_CLUSTER = 1 << 17   # the shortest row whose lines a cluster shares
K_FIR_TAPS = 255        # a sharp low-pass over the biosignal day's rows


def phase_k(dev, card: str, sig) -> tuple:
    """Phase K: the FFT past 8192 points and the FIR past 64 taps through
    the user entries, each run with the launch counts set to 0 just before
    and read just after. K1 `fft` over a row of `K_FFT_N` complex points
    (in float16 the record scaled by 2^-6, so that its tones stay in
    float16's range) and `rfft` over `K_FFT_N` real samples (a 2^19-point
    row): two launches each, the four-step's columns and rows, held
    within `FFT_TOL` of the plain version and of float64 `torch.fft`
    (measured only). K2 `fir`
    with `K_FIR_TAPS` taps over the day's 10,797 x 2048 frames in every
    row dtype (integers at full scale): one launch each, bitwise the plain
    version. Then the device times beside the bounds, the plain versions
    and one PyTorch call each (`torch.fft.fft`, `conv1d`), also of one
    float32 row of `K_FFT_SMALL` and of `K_FFT_CLUSTER` points; returns
    (the report, the two kernel entries of the result line)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.fir import lowpass_taps
    from repro_torch.kernels.fft.kernel import (FFT_TOL, device_twiddles,
                                                fft_plain)
    from repro_torch.kernels.fft.ops import fft, rfft
    from repro_torch.kernels.fir.kernel import fir_plain
    from repro_torch.kernels.fir.ops import fir
    from repro_torch.serve.stream import frame_signal

    t_phase = time.perf_counter()
    report: dict = {"runs": {}, "times": {}}
    g = torch.Generator(device=dev).manual_seed(7)
    # ---- K1: a 17-minute record at 1 kHz, as complex rows and real
    t = torch.arange(K_FFT_N, device=dev, dtype=torch.float64) / 1000.0
    rec = (torch.sin(2 * math.pi * 0.25 * t) + 0.3 * torch.sin(
        2 * math.pi * 1.2 * t)).float() + 0.1 * torch.randn(
        K_FFT_N, generator=g, device=dev)
    del t
    four = {("fft", "four_step_columns"): 1, ("fft", "four_step_rows"): 1}
    re, im = rec[None], torch.roll(rec, 1)[None]
    fft_err, fft_launches = {}, 0
    for dname in FFT_DTYPES:
        dtype = getattr(torch, dname)
        # a unit tone sums to N/2 = 524,288 at its bin, past float16's
        # 65,504: the float16 record is scaled by 2^-6 first
        scale = 2.0 ** -6 if dtype == torch.float16 else 1.0
        xr, xi = (scale * re).to(dtype), (scale * im).to(dtype)
        for inverse in (False, True):
            got, launched = counted(lambda: fft(xr, xi, inverse=inverse))
            expect_launches(f"K fft {dname} inverse={inverse}", launched,
                            four)
            fft_launches += sum(launched["fft"].values())
            want = fft_plain(xr, xi, inverse=inverse)
            fft_err[f"fft {dname} inverse={inverse}"] = max(
                check_scaled(f"K fft {dname} inverse={inverse}", a, b,
                             FFT_TOL[dname]) for a, b in zip(got, want))
            check_wrong_fft(f"K fft {dname}", xr, xi, want, inverse)
    (sr, si), launched = counted(lambda: rfft(rec[None]))
    expect_launches("K rfft", launched, four)
    fft_launches += sum(launched["fft"].values())
    ref = torch.fft.rfft(rec.double())
    scale = float(ref.abs().max())
    rerr = max(float((sr[0].double() - ref.real).abs().max()),
               float((si[0].double() - ref.imag).abs().max()))
    if not rerr <= FFT_TOL["float32"] * scale:
        raise AssertionError(f"K rfft: |diff| {rerr:.3e} > "
                             f"{FFT_TOL['float32']} x {scale:.3e}")
    fft_err["rfft vs float64"] = rerr
    report["runs"]["fft"] = {"max_abs_err": fft_err,
                             "launches": fft_launches}
    print(f"phase K fft: a {K_FFT_N}-point row (a 17-minute record at 1 "
          f"kHz) in {'/'.join(FFT_DTYPES)} both ways, and rfft of the "
          f"record ({K_FFT_N // 2}-point row): two launches each (four-step "
          f"columns, rows), within FFT_TOL of the plain version, max |diff| "
          + ", ".join(f"{k} {v:.3e}" for k, v in fft_err.items())
          + f"; {fft_launches} launches")
    # ---- K2: 255 taps over the day's frames in every row dtype
    day = frame_signal(sig, WINDOW, HOP)
    taps = torch.as_tensor(lowpass_taps(K_FIR_TAPS, cutoff=0.02),
                           device=dev)
    rows, fir_launches = {}, 0
    for dname in FIR_DTYPES:
        dtype = getattr(torch, dname)
        x = day.to(dtype) if dtype.is_floating_point else \
            full_scale(day.flatten(), dtype).reshape(day.shape)
        y, launched = counted(lambda: fir(x, taps))
        expect_launches(f"K fir {dname}", launched, {("fir", "rows"): 1})
        fir_launches += launched["fir"]["rows"]
        check_fir(f"K fir {dname} {K_FIR_TAPS} taps", y, fir_plain(x, taps))
        rows[dname] = x
        del y
    report["runs"]["fir"] = {"launches": fir_launches}
    print(f"phase K fir: {K_FIR_TAPS} taps over the day's {day.shape[0]} x "
          f"{day.shape[1]} frames in {'/'.join(FIR_DTYPES)}, one launch "
          f"each, bitwise the plain version; {fir_launches} launches")
    # ---- device times (CUDA events) beside the bound, the plain version
    # and one PyTorch call computing the same function
    def library_fft(xr, xi):
        """torch.fft.fft on the complex tensor of (xr, xi), or None where
        PyTorch has no complex type or no transform for the dtype."""
        if xr.dtype == torch.bfloat16:
            return None
        z = torch.complex(xr, xi)
        try:
            torch.fft.fft(z)
        except RuntimeError:
            return None
        return lambda: torch.fft.fft(z)

    def library_fir(x, h):
        """conv1d of ``x``'s rows, left-padded, with ``h`` flipped, or None
        where PyTorch has no convolution for the dtype (integers)."""
        if not x.dtype.is_floating_point:
            return None
        k = h.shape[0]
        w = h.flip(0).reshape(1, 1, k).to(x.dtype)
        padded = F.pad(x, (k - 1, 0)).unsqueeze(1)
        return lambda: F.conv1d(padded, w)

    cases = []
    for dname in FFT_DTYPES:
        dtype = getattr(torch, dname)
        for n, nrows in ((K_FFT_N, 1), (K_FFT_N, 64), (FFT_BIG, 1),
                         (K_FFT_SMALL, 1), (K_FFT_CLUSTER, 1)):
            if n not in (K_FFT_N,) and dname != "float32":
                continue
            xr = torch.randn(nrows, n, generator=g, device=dev).to(dtype)
            xi = torch.randn(nrows, n, generator=g, device=dev).to(dtype)
            cases.append((f"fft {dname} {nrows} x {n}",
                          lambda xr=xr, xi=xi: fft(xr, xi),
                          (lambda xr=xr, xi=xi: fft_plain(xr, xi))
                          if n <= K_FFT_N else None,
                          library_fft(xr, xi),
                          fft_work(nrows, n, xr.element_size())))
    for dname in FIR_DTYPES:
        x = rows[dname]
        for k in ((65, K_FIR_TAPS, 2048) if dname == "float32"
                  else (K_FIR_TAPS,)):
            h = taps if k == K_FIR_TAPS else torch.as_tensor(
                lowpass_taps(k, cutoff=min(0.4, 8.0 / k)), device=dev)
            cases.append((f"fir {dname} {k} taps",
                          lambda x=x, h=h: fir(x, h),
                          lambda x=x, h=h: fir_plain(x, h),
                          library_fir(x, h),
                          fir_work(*x.shape, k, x.element_size())))
    for label, kfn, pfn, lfn, work in cases:
        bms, by = bound_ms(*work)
        row = {"ms": event_ms(kfn, 10),
               "plain_ms": None if pfn is None else event_ms(pfn, 2),
               "library_ms": None if lfn is None else event_ms(lfn, 10),
               "bound_ms": bms, "bound_by": by}
        report["times"][label] = row
        print(f"time K {label}: kernel {row['ms']:.4f} ms, plain "
              + ("-" if row["plain_ms"] is None else
                 f"{row['plain_ms']:.3f} ms")
              + ", library "
              + ("-" if row["library_ms"] is None else
                 f"{row['library_ms']:.4f} ms")
              + f", bound {bms:.5f} ms ({by}) [{card}]")
    del cases, rows
    device_twiddles.cache_clear()
    torch.cuda.empty_cache()
    fft_row = report["times"][f"fft float32 1 x {K_FFT_N}"]
    fir_row = report["times"][f"fir float32 {K_FIR_TAPS} taps"]
    kernels = [
        {"name": "fft[four_step]", "route": "cuda", "source": FFT_SOURCE,
         "replaces": FFT_REPLACES, "launches": fft_launches,
         "max_abs_err": fft_err["fft float32 inverse=False"], **fft_row},
        {"name": f"fir[rows, {K_FIR_TAPS} taps]", "route": "cuda",
         "source": FIR_SOURCE, "replaces": FIR_REPLACES,
         "launches": fir_launches, "max_abs_err": 0.0, **fir_row}]
    report["wall_s"] = time.perf_counter() - t_phase
    print(f"phase K: {report['wall_s']:.1f} s wall")
    return report, kernels


def phase_q(dev, card: str) -> dict:
    """Phase Q: the two entries without a JAX counterpart in the port
    before, as a user calls them on the card (`launch.quickstart.main`,
    `launch.asr_frontend.main`, each printing its example's lines and
    raising unless its checks pass), each with the launch counts set to 0
    just before and read just after."""
    from repro_torch.launch import asr_frontend, quickstart

    t_phase = time.perf_counter()
    report = {}
    r, got = counted(lambda: quickstart.main([]))
    expect_launches("quickstart", got, {("fft", "rows"): 1,
                                        ("fir", "rows"): 1})
    report["quickstart"] = {
        "rfft_rel_err": r["fft_fir"]["rfft_rel_err"],
        "archsim_cycles": r["archsim"]["cycles"],
        "archsim_uj": r["archsim"]["uj"], "loss": r["lm"]["loss"],
        "launches": {"fft": 1, "fir": 1}}
    r, got = counted(lambda: asr_frontend.main([]))
    n = r["logmel"].shape[0]
    batches = -(-n // 32)
    expect_launches("asr_frontend", got, {
        ("asr_graph", "stream"): 3 + batches, ("fir", "rows"): 1,
        ("fft", "rows"): 1})
    report["asr_frontend"] = {
        "frames": n, "oracle_err": r["oracle_err"],
        "staged_ms": r["staged_ms"], "fused_ms": r["fused_ms"],
        "tokens": r["ticket"]["tokens"],
        "launches": {"asr_graph.stream": 3 + batches, "fir": 1, "fft": 1}}
    print(f"phase Q: quickstart launched the FFT and FIR kernels once each "
          f"(rfft rel err {report['quickstart']['rfft_rel_err']:.3e}, "
          f"archsim {report['quickstart']['archsim_cycles']} cycles, loss "
          f"{report['quickstart']['loss']:.6f}); asr_frontend launched the "
          f"ASR graph kernel {3 + batches} times (2 one-call featurizations, "
          f"{batches} stream batches, 1 ticket) and the FIR and FFT once "
          f"each (asr_staged {r['staged_ms']:.2f} ms vs fused "
          f"{r['fused_ms']:.2f} ms wall) [{card}]")
    report["wall_s"] = time.perf_counter() - t_phase
    print(f"phase Q: {report['wall_s']:.1f} s wall")
    return report


def mesh_check(dev, card: str) -> dict:
    """The port's sharding rules on the card: `make_local_mesh(1, 1)`
    over it and qwen1.5-0.5b's full-width parameters (seed 0) laid out by
    the serve strategy's placements, each local shard bitwise the
    parameter it came from. On one rank the layout moves no data
    (``src_data_rank=None``: each rank keeps its own slice)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model, init_model_params
    from repro_torch.models.layers import axes_tree, tree_items
    from repro_torch.sharding.rules import Strategy, sharding_tree

    t_phase = time.perf_counter()
    made = not dist.is_initialized()
    mesh = make_local_mesh(data=1, model=1, device=dev)
    try:
        model = build_model(get_config(LM_ARCH), device=dev)
        params = init_model_params(model, 0, device=dev)
        sh = sharding_tree(axes_tree(model.schema), params, mesh,
                           Strategy("serve"))
        n, sharded = 0, 0
        for (path, p), (_, s) in zip(tree_items(params), tree_items(sh)):
            d = distribute_tensor(p, mesh, s.placements, src_data_rank=None)
            if not torch.equal(d.to_local(), p):
                raise AssertionError(f"mesh: {'/'.join(path)} local shard "
                                     f"differs")
            n += 1
            sharded += any(e is not None for e in s.spec)
        del params, sh
    finally:
        if made:
            dist.destroy_process_group()
    print(f"mesh check: {n} qwen1.5-0.5b parameters laid out on "
          f"make_local_mesh(1, 1) over {mesh.device_type} by the serve "
          f"strategy ({sharded} with a sharded dim), every local shard "
          f"bitwise its parameter, {time.perf_counter() - t_phase:.1f} s "
          f"wall [{card}]")
    return {"leaves": n, "sharded": sharded,
            "wall_s": time.perf_counter() - t_phase}


# phase R: the multi-rank substrate on one card
R_BATCH, R_PROMPT, R_DECODE, R_MAX_LEN = 4, 64, 8, 128
# GPipe at one stage at dryrun_pp's layer widths (d 1024, d_ff 2816, 24
# layers), bfloat16, a batch of 8 x 256 tokens in 4 microbatches, against
# the loop over the whole batch: relative L2 errors of the output and of
# the gradients. The pipeline's weight gradient is the sum of 4
# microbatch gradients each rounded to bfloat16 (2^-8), the loop's one
# product rounded once: 3.2e-3 in a CPU rehearsal at cut widths; 2e-2
# leaves room for 5 roundings, where a lost hand-off reads order 1
R_PP = (8, 256, 4)
GPIPE_TOL = 2e-2
R_DRYRUN = ("qwen1.5-0.5b", f"train_{T_BATCH}x{T_SEQ}", "1x1")


def r_serve(dev, card: str, mesh) -> dict:
    """R1: `make_serve_step` on ``mesh`` (one rank) against the model's
    own prefill and decode on the same bfloat16 weights and cache: one
    prefill of R_BATCH prompts of R_PROMPT tokens and R_DECODE greedy
    decode steps, logits and every cache leaf bitwise; what the check
    reads from a decode that does not write its cache back (the next
    step's logits; the run fails unless it differs)."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import attention, build_model, init_cache
    from repro_torch.models import init_model_params
    from repro_torch.models.layers import tree_items, tree_map
    from repro_torch.serve.step import make_serve_step
    from repro_torch.sharding.rules import distribute_tree

    cfg = get_config(LM_ARCH)
    model = build_model(cfg, device=dev)
    params = tree_map(lambda t: t.to(cfg.compute_dtype),
                      init_model_params(model, 0, device=dev))
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab_size,
                                          (R_BATCH, R_PROMPT)),
                             dtype=torch.int32, device=dev)
    bundle = make_serve_step(
        model, mesh, {"tokens": torch.empty(R_BATCH, R_PROMPT,
                                            dtype=torch.int32,
                                            device="meta")},
        batch_size=R_BATCH, max_len=R_MAX_LEN)
    dparams = distribute_tree(params, bundle.param_shardings)

    def same(tag, a, b):
        if not torch.equal(a, b):
            diff = float((a.float() - b.float()).abs().max())
            raise AssertionError(f"R1 {tag}: the serve step differs from "
                                 f"the model: max |diff| {diff}")

    def decode_batch(tok, t):
        return {"tokens": tok, "cache_len": torch.tensor(
            R_PROMPT + t, dtype=torch.int32, device=dev)}

    with torch.no_grad():
        cache0 = init_cache(model, R_BATCH, R_MAX_LEN, device=dev)
        want, wcache = model.prefill(params, {"tokens": prompt}, cache0)
        got, gcache = bundle.prefill_fn(
            dparams, distribute_tree({"tokens": prompt},
                                     bundle.batch_shardings),
            distribute_tree(cache0, bundle.cache_shardings))
        same("prefill logits", got.full_tensor(), want)
        tokens, walls, toks = [], [], []
        for t in range(R_DECODE):
            tok = want[:, -1].argmax(-1).to(torch.int32)[:, None]
            toks.append(tok)
            tokens.append(tok[:, 0].tolist())
            want, wcache = model.decode(params, decode_batch(tok, t), wcache)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, gcache = bundle.decode_fn(dparams, decode_batch(tok, t),
                                           gcache)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            same(f"decode {t} logits", got.full_tensor(), want)
            for (path, a), (_, b) in zip(tree_items(gcache),
                                         tree_items(wcache)):
                same(f"decode {t} cache {'/'.join(path)}", a.to_local(), b)
        last = decode_batch(toks[-1], R_DECODE - 1)
        busy, launches = device_busy(lambda: bundle.decode_fn(
            dparams, last, gcache))
        # the check's bite: step 0 run without its cache write, then step 1
        fresh = model.prefill(params, {"tokens": prompt}, cache0)[1]
        ok = tree_map(torch.clone, fresh)
        model.decode(params, decode_batch(toks[0], 0), ok)
        want1 = model.decode(params, decode_batch(toks[1], 1), ok)[0]
        wrong = distribute_tree(fresh, bundle.cache_shardings)
        right_write = attention._write_rows
        attention._write_rows = lambda cache, slot, new: None
        try:
            bundle.decode_fn(dparams, decode_batch(toks[0], 0), wrong)
        finally:
            attention._write_rows = right_write
        bad = bundle.decode_fn(dparams, decode_batch(toks[1], 1),
                               wrong)[0].full_tensor()
        unwritten = float((bad.float() - want1.float()).abs().max())
    if not unwritten > 0:
        raise AssertionError("R1: a decode that did not write its cache back "
                             "went unnoticed")
    host = statistics.median(walls[2:])
    print(f"R1 serve step on make_local_mesh(1, 1) ({LM_ARCH}, "
          f"{cfg.num_layers} layers, bfloat16 weights, {R_BATCH} prompts of "
          f"{R_PROMPT} tokens): prefill and {R_DECODE} decode steps bitwise "
          f"model.prefill / model.decode (logits and every cache leaf); "
          f"greedy tokens {tokens}; a decode step {host:.2f} ms host wall "
          f"(median of steps 3-{R_DECODE}), the card busy {busy:.3f} ms "
          f"over {launches} launches; a decode without its cache write "
          f"reads max |diff| {unwritten:.3e} at the next step (flagged) "
          f"[{card}]")
    return {"tokens": tokens, "decode_host_ms": host, "walls_ms": walls,
            "device_busy_ms": busy, "launches": launches,
            "unwritten_cache_reading": unwritten}


def r_gpipe(dev, card: str, pipe_mesh) -> dict:
    """R2: `gpipe_apply` at one stage on the card at `launch/dryrun_pp.py`'s
    widths, forward and gradient against the sequential loop within
    GPIPE_TOL; what the check reads from a schedule that loses one
    hand-off (the stage fed zeros at one tick; the run fails unless the
    tolerance flags it)."""
    import torch

    from repro_torch.launch import dryrun_pp
    from repro_torch.sharding.pipeline import gpipe_apply

    B, S, M = R_PP
    g = torch.Generator(device=dev).manual_seed(0)
    L, d, f = dryrun_pp.LAYERS, dryrun_pp.D, dryrun_pp.D_FF

    def draw(*shape, std):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(
            torch.bfloat16)
    w1 = draw(L, d, f, std=d ** -0.5).requires_grad_()
    w2 = draw(L, f, d, std=f ** -0.5).requires_grad_()
    x = draw(B, S, d, std=1.0)
    layer = dryrun_pp.layer

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    h = x
    for i in range(L):
        h = layer((w1[i], w2[i]), h)
    gw = torch.autograd.grad(h.float().square().sum(), (w1, w2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = gpipe_apply(layer, (w1[None], w2[None]), x, mesh=pipe_mesh,
                    microbatches=M)
    gp = torch.autograd.grad(y.float().square().sum(), (w1, w2))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    fwd = rel(y, h)
    grad = max(rel(a, b) for a, b in zip(gp, gw))
    calls = []

    def lossy(p, hh):              # tick 2's input lost on its way in
        calls.append(1)
        return layer(p, hh * 0 if len(calls) == 2 * L + 1 else hh)
    with torch.no_grad():
        lost = rel(gpipe_apply(lossy, (w1[None], w2[None]), x,
                               mesh=pipe_mesh, microbatches=M), h)
    print(f"R2 gpipe_apply at 1 stage on the card ({L} layers of h + "
          f"tanh(h @ w1) @ w2, d {d}, d_ff {f}, bfloat16, batch {B} x {S} "
          f"in {M} microbatches): against the sequential loop forward "
          f"{fwd:.3e}, gradient {grad:.3e} (relative L2, tol {GPIPE_TOL}); "
          f"a lost hand-off reads {lost:.3e} (flagged); forward + backward "
          f"{wall:.1f} ms wall [{card}]")
    if not (fwd <= GPIPE_TOL and grad <= GPIPE_TOL):
        raise AssertionError(f"R2: gpipe_apply off the loop: forward {fwd}, "
                             f"gradient {grad}")
    if not lost > GPIPE_TOL:
        raise AssertionError(f"R2: a lost hand-off went unnoticed ({lost})")
    return {"forward_rel_err": fwd, "grad_rel_err": grad,
            "lost_hand_off_reading": lost, "wall_ms": wall}


def r_psum(dev, card: str, mesh) -> dict:
    """R3: `psum_compressed` over the one-rank mesh's "data" axis equals
    the int8 round trip of its input, bitwise."""
    import torch

    from repro_torch.train.compress import (dequantize_block_int8,
                                            psum_compressed,
                                            quantize_block_int8)

    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(1024, 1000, generator=g, device=dev)
    got = psum_compressed(x, "data", mesh=mesh)
    q, s = quantize_block_int8(x)
    if not torch.equal(got, dequantize_block_int8(q, s, x.shape)):
        raise AssertionError("R3: psum_compressed at world 1 is not the "
                             "quantization round trip")
    print(f"R3 psum_compressed over a world of 1 on the card: "
          f"{x.numel():,} values bitwise dequantize(quantize(x)) [{card}]")
    return {"values": x.numel()}


# R4's gate on the dry run's peak over the measured one
R_PEAK_RATIO = (0.8, 1.25)


def r_dryrun(card: str, t1_busy_ms=None, t1_time=None, dev=None) -> dict:
    """R4: `python -m repro_torch.launch.dryrun` on the T1 step (a 1 x 1
    mesh, batch T_BATCH x T_SEQ; a fake process group on the host, no
    card) in a subprocess: its per-device counts and roofline bound
    beside phase T1's busy time and `train_work`'s bound, and its
    `peak_bytes` beside the card's `max_memory_allocated` over one T1
    step with one state held (`t1_step_memory` on ``dev``, less what the
    card held before: earlier phases' leftovers are not the step's): the
    ratio must lie in `R_PEAK_RATIO`. Phase T1's own readings (``t1_time``:
    the phase's peak over its runs, and its step's beside what that
    phase still held) are printed beside it."""
    import os

    from repro_torch.analysis.roofline import train_work
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    arch, shape, mesh = R_DRYRUN
    out = ROOT / "chiprun_out" / "dryrun_r"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", str(out)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"R4: the dry run failed: {proc.stdout[-2000:]}"
                             f"{proc.stderr[-2000:]}")
    rec = json.loads((out / f"{arch}__{shape}__{mesh}.json").read_text())
    oc, rl = rec["op_cost"], rec["roofline"]
    work = train_work(build_model(get_config(arch), device="meta"),
                      T_BATCH * T_SEQ, T_SEQ, T_BATCH)
    busy = (f"{t1_busy_ms:.2f} ms" if t1_busy_ms is not None else
            "not measured in this run")
    print(f"R4 dry run of the T1 step ({arch}, {mesh} mesh, {shape}; a "
          f"{wall:.1f} s subprocess on the host): {oc['flops']:,} FLOPs, "
          f"{oc['bytes']:,} bytes (unfused), roofline bound "
          f"{rl['bound_s'] * 1e3:.2f} ms ({rl['dominant']}; compute "
          f"{rl['compute_s'] * 1e3:.2f} ms at 989 TFLOP/s, memory "
          f"{rl['memory_s'] * 1e3:.2f} ms); train_work's bound "
          f"{work['bound_ms']:.2f} ms "
          f"({work['body_tflop'] + work['head_tflop']:.3f} TFLOP); phase "
          f"T1's step busy {busy} [{card}]")
    mem = rec["memory"]
    held, t1_peak, before = t1_step_memory(dev)
    ratio = mem["peak_bytes"] / t1_peak
    phase_t = ("not run" if t1_time is None else
               f"{t1_time['max_memory_gib']:.3f} GiB over its runs, "
               f"{t1_time['step_peak_bytes'] / 2**30:.3f} GiB over its "
               f"step with {t1_time['step_held_bytes'] / 2**30:.3f} GiB "
               f"held")
    print(f"R4 memory of the T1 step: the dry run's peak "
          f"{mem['peak_bytes']:,} bytes ({mem['peak_bytes'] / 2**30:.3f} "
          f"GiB: arguments {mem['argument_size_in_bytes']:,}, outputs "
          f"{mem['output_size_in_bytes']:,}, temporaries "
          f"{mem['temp_size_in_bytes']:,}) against the card's "
          f"max_memory_allocated over one step with one state held "
          f"({held / 2**30:.3f} GiB), less the {before / 2**30:.3f} GiB "
          f"allocated before the state was made, {t1_peak:,} bytes "
          f"({t1_peak / 2**30:.3f} GiB): ratio {ratio:.4f}; phase T1 read "
          f"{phase_t} [{card}]")
    if not R_PEAK_RATIO[0] <= ratio <= R_PEAK_RATIO[1]:
        raise AssertionError(f"R4: the dry run's peak is {ratio:.4f} of "
                             f"the measured one, outside {R_PEAK_RATIO}")
    return {"flops": oc["flops"], "bytes": oc["bytes"],
            "bound_ms": rl["bound_s"] * 1e3, "dominant": rl["dominant"],
            "train_work_bound_ms": work["bound_ms"],
            "train_work_tflop": work["body_tflop"] + work["head_tflop"],
            "t1_busy_ms": t1_busy_ms, "memory": mem,
            "t1_step_held_bytes": held, "t1_step_peak_bytes": t1_peak,
            "allocated_before_bytes": before,
            "peak_ratio": ratio,
            "wall_s": wall}


def phase_r(dev, card: str, t1_busy_ms=None, t1_time=None) -> dict:
    """Phase R: the multi-rank substrate on one card (one rank: NCCL,
    world 1), with the launch counts set to 0 before and read after (no
    kernel of the port may launch): R1 the serve step, R2 GPipe, R3 the
    compressed collective, R4 the dry run of the T1 step."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_local_mesh

    t_phase = time.perf_counter()
    made = not dist.is_initialized()
    mesh = make_local_mesh(data=1, model=1, device=dev)
    try:
        pipe = init_device_mesh("cuda", (1,), mesh_dim_names=("pipe",))

        def run():
            return {"serve": r_serve(dev, card, mesh),
                    "gpipe": r_gpipe(dev, card, pipe),
                    "psum": r_psum(dev, card, mesh)}
        report, got = counted(run)
    finally:
        if made:
            dist.destroy_process_group()
    if any(n for entries in got.values() for n in entries.values()):
        raise AssertionError(f"phase R launched a kernel: {got}")
    gc.collect()
    torch.cuda.empty_cache()
    report["dryrun"] = r_dryrun(card, t1_busy_ms, t1_time, dev)
    report["wall_s"] = time.perf_counter() - t_phase
    print(f"phase R: no kernel of the port launched; "
          f"{report['wall_s']:.1f} s wall")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="phases 1, 2 and A1 only (build + kernels vs "
                         "plain)")
    ap.add_argument("--phase-m", action="store_true",
                    help="the card's name and phase M only (no build, no "
                         "result lines)")
    ap.add_argument("--phase-t", action="store_true",
                    help="the card's name and phase T only (no build, no "
                         "result lines)")
    ap.add_argument("--phase-u", action="store_true",
                    help="the card's name and phases U and E only (kernels "
                         "built at first use, no result lines)")
    ap.add_argument("--phase-d", action="store_true",
                    help="the card's name and phase D only (kernels built "
                         "at first use, no result lines)")
    ap.add_argument("--phase-q", action="store_true",
                    help="the card's name, phase Q and the mesh check only "
                         "(kernels built at first use, no result lines)")
    ap.add_argument("--phase-c", action="store_true",
                    help="the card's name and phase C's column deals only, "
                         "serial and over each column mesh, four cards' "
                         "included on a host with four (the biosignal "
                         "kernel built at first use, no result lines)")
    ap.add_argument("--phase-k", action="store_true",
                    help="the card's name and phase K only (kernels built "
                         "at first use, no result lines)")
    ap.add_argument("--phase-r", action="store_true",
                    help="the card's name and phase R only (no build, no "
                         "result lines)")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core.biosignal import make_app, synthetic_respiration
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.fft.kernel import FFT_TOL, fft_cuda, fft_plain
    from repro_torch.kernels.fir.kernel import fir_cuda, fir_plain
    # the standalone kernels declare themselves to _cuda when imported
    from repro_torch.kernels.flash_attention import kernel as _flash  # noqa
    from repro_torch.kernels.pipeline.asr import (asr_staged,
                                                  make_asr_frontend)
    from repro_torch.kernels.rope import kernel as _rope  # noqa: F401
    from repro_torch.kernels.shuffle import kernel as _shuffle  # noqa
    from repro_torch.kernels.pipeline.graph import (
        get_graph_factory, graph_frames_call, graph_frames_plain,
        graph_ring_call, graph_ring_plain, graph_stream_call,
        graph_stream_plain, ring_chunk_samples, stream_frame_count)
    from repro_torch.kernels.pipeline.kernel import OUTPUTS
    from repro_torch.kernels.pipeline.ops import graph_pipeline_stream
    from repro_torch.kernels.pipeline.ref import pipeline_staged
    from repro_torch.serve.resident import ResidentConfig, ResidentStream
    from repro_torch.serve.stream import (BiosignalStream, StreamConfig,
                                          frame_signal)

    report: dict = {}
    # ---- phase 1: card, build (one nvcc per source, all at once)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    if args.phase_m or args.phase_t:
        dev = torch.device("cuda", 0)
        tag = "m" if args.phase_m else "t"
        report[f"phase_{tag}"] = (phase_m if args.phase_m else phase_t)(
            dev, card)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / f"chip_smoke_{tag}.json").write_text(
            json.dumps(report, indent=1, default=str))
        return 0
    if args.phase_u:
        dev = torch.device("cuda", 0)
        report["phase_u"] = phase_u(
            dev, card, make_app(device=dev), make_asr_frontend(device=dev),
            synthetic_respiration(1, DAY_SAMPLES, seed=0, device=dev)[0][0],
            synthetic_audio(HOUR_SAMPLES, seed=0, device=dev))
        report["phase_e"] = phase_e(dev, card)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_u.json").write_text(
            json.dumps(report, indent=1, default=str))
        return 0
    if args.phase_d:
        dev = torch.device("cuda", 0)
        report["phase_d"] = phase_d(
            dev, card, make_app(device=dev),
            synthetic_respiration(1, DAY_SAMPLES, seed=0, device=dev)[0][0],
            make_asr_frontend(device=dev),
            synthetic_audio(HOUR_SAMPLES, seed=0, device=dev))
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_d.json").write_text(
            json.dumps(report, indent=1, default=str))
        return 0
    if args.phase_c:
        dev = torch.device("cuda", 0)
        app = make_app(device=dev)
        sig = synthetic_respiration(1, DAY_SAMPLES, seed=0, device=dev)[0][0]
        n = stream_frame_count(DAY_SAMPLES, WINDOW, HOP)
        day_ref = BiosignalStream(app, StreamConfig(
            window=WINDOW, hop=HOP, batch_windows=8)).process(sig)
        report["phase_c"] = column_paths(app, sig, day_ref, n, card,
                                         runners=False)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_c.json").write_text(
            json.dumps(report, indent=1, default=str))
        return 0
    if args.phase_k:
        dev = torch.device("cuda", 0)
        report["phase_k"] = phase_k(dev, card, synthetic_respiration(
            1, DAY_SAMPLES, seed=0, device=dev)[0][0])[0]
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_k.json").write_text(
            json.dumps(report, indent=1, default=str))
        return 0
    if args.phase_r:
        report["phase_r"] = phase_r(torch.device("cuda", 0), card)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_r.json").write_text(
            json.dumps(report, indent=1, default=str))
        return 0
    if args.phase_q:
        dev = torch.device("cuda", 0)
        report["phase_q"] = phase_q(dev, card)
        report["mesh"] = mesh_check(dev, card)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_q.json").write_text(
            json.dumps(report, indent=1, default=str))
        return 0
    declare_rope_wrong_slot()
    t0 = time.perf_counter()
    builds = _cuda.build_all()
    wall = time.perf_counter() - t0
    print(f"build: {len(builds)} kernels in {wall:.2f} s wall ("
          + ", ".join(f"{k} {b.seconds:.2f} s" for k, b in builds.items())
          + " of nvcc)")
    report["build"] = {k: {"seconds": b.seconds, "log": b.log}
                       for k, b in builds.items()}
    for k, b in builds.items():
        ptx = [ln.strip() for ln in b.log.splitlines() if "registers" in ln]
        if ptx:
            print(f"ptxas {k}: {ptx[0]}")
    print(ptxas_summary("flash_attention", builds["flash_attention"].log))
    print(sass_summary(builds["flash_attention"].path))

    dev = torch.device("cuda", 0)
    app = make_app(device=dev)
    graph, operands = get_graph_factory("biosignal")(app)
    asr_app = make_asr_frontend(device=dev)
    asr_graph, asr_ops = get_graph_factory("asr")(asr_app)

    # ---- phases 2 and A1: every kernel against its plain version
    max_err = biosignal_kernels_vs_plain(app, graph, operands, dev)
    max_err.update(asr_kernels_vs_plain(asr_graph, asr_ops, dev))
    max_err.update(standalone_kernels_vs_plain(dev))
    if args.quick:
        return 0

    # ---- phase 3: the biosignal main path over a 24-hour recording
    sig = synthetic_respiration(1, DAY_SAMPLES, seed=0, device=dev)[0][0]
    n = stream_frame_count(DAY_SAMPLES, WINDOW, HOP)
    if n != 10_797:
        raise AssertionError(f"{n} frames in a day, expected 10797")
    main_out, launches, rates = {}, {}, {}
    for B in (8, 512):
        for sel in (("features", "margin", "class"), OUTPUTS):
            cfg = StreamConfig(window=WINDOW, hop=HOP, batch_windows=B,
                               outputs=sel)
            stream = BiosignalStream(app, cfg)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)

            def run():
                t0.record()
                out = stream.process(sig)
                t1.record()
                return out

            out, got = counted(run)
            expect_launches(f"B={B} {sel}", got,
                            {("biosignal_graph", "stream"): -(-n // B)})
            for k, v in out.items():
                if v.shape[0] != n:
                    raise AssertionError(f"{k}: {v.shape[0]} rows != {n}")
                if v.is_floating_point() and not bool(v.isfinite().all()):
                    raise AssertionError(f"{k}: non-finite values")
            if not bool(((out["class"] == 0) | (out["class"] == 1)).all()):
                raise AssertionError("class outside {0, 1}")
            ms = t0.elapsed_time(t1)
            tag = f"B={B} {'all' if sel == OUTPUTS else 'no-filtered'}"
            rates[tag] = n / (ms / 1e3)
            launches[tag] = got["biosignal_graph"]["stream"]
            main_out[(B, sel)] = out
            print(f"main path {tag}: {n} frames in {ms:.1f} ms = "
                  f"{rates[tag]:.0f} windows/s, {launches[tag]} stream "
                  f"launches [{kind}; {card}]")
    # every row of every main-path run against the plain version over the
    # whole day, in slices of frames; the same slices give this data's
    # candidate and extremum counts for the bounds of phase 5
    cand, ext, worst = [], [], 0.0
    for f0 in range(0, n, 2048):
        f1 = min(n, f0 + 2048)
        plain = graph_stream_plain(sig[f0 * HOP: (f1 - 1) * HOP + WINDOW],
                                   operands, graph=graph, window=WINDOW,
                                   hop=HOP)
        for (B, sel), out in main_out.items():
            worst = max(worst, check_close(
                f"main B={B} frames {f0}:{f1}",
                {k: v[f0:f1] for k, v in out.items()},
                {k: plain[k] for k in out}))
        c, e = extremum_counts(plain["filtered"])
        cand.append(c)
        ext.append(e)
        del plain
    cand_cum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          torch.cat(cand).cumsum(0)]).tolist()
    ext_cum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cat(ext).cumsum(0)]).tolist()
    max_err["main"] = worst
    print(f"main path vs plain on the card: all {n} rows of the "
          f"{len(main_out)} runs, class exact, max |diff| {worst:.3e}; "
          f"{cand_cum[n] / n:.1f} candidates, {ext_cum[n] / n:.1f} extrema "
          f"per frame")
    # the host-framed reference (framed kernel entry), bitwise equal
    feat = ("features", "margin", "class")
    cfg = StreamConfig(window=WINDOW, hop=HOP, batch_windows=8,
                       framing="host", outputs=feat)
    host, got = counted(lambda: BiosignalStream(app, cfg).process(sig))
    expect_launches("host framing", got,
                    {("biosignal_graph", "frames"): -(-n // 8)})
    check_equal("host framing == kernel framing", host, main_out[(8, feat)])
    launches["frames"] = got["biosignal_graph"]["frames"]
    print(f"host-framed reference B=8: bitwise equal to the raw-chunk "
          f"path, {launches['frames']} frames launches")

    # ---- phase 4: the resident loop, bitwise equal to phase 3
    for B, sel in ((8, feat), (512, OUTPUTS)):
        rcfg = ResidentConfig(ring_depth=4, drain_interval=4)
        rs = ResidentStream(app, StreamConfig(window=WINDOW, hop=HOP,
                                              batch_windows=B, outputs=sel),
                            rcfg)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)

        def run():
            t0.record()
            out = rs.process(sig)
            t1.record()
            return out

        res, got = counted(run)
        sweeps = -(-n // (4 * B))
        expect_launches(f"resident B={B}", got,
                        {("biosignal_graph", "ring"): sweeps})
        check_equal(f"resident B={B}", res, main_out[(B, sel)])
        if rs.last_drains[-1] != n:
            raise AssertionError(f"drained {rs.last_drains[-1]} != {n}")
        ms = t0.elapsed_time(t1)
        tag = f"resident B={B} ring_depth=4"
        rates[tag] = n / (ms / 1e3)
        if B == 8:
            launches["ring"] = got["biosignal_graph"]["ring"]
        print(f"{tag}: bitwise equal to the host-driven stream, drained "
              f"{rs.last_drains[-1]} = {n} frames in "
              f"{len(rs.last_drains)} drains, {sweeps} ring launches, "
              f"{rates[tag]:.0f} windows/s [{kind}; {card}]")

    # ---- phase C: the column deal and the fault-tolerant runner
    columns = column_paths(app, sig, main_out[(8, OUTPUTS)], n, card)
    del main_out

    # ---- phase A2: the ASR main path over one hour of 16 kHz audio
    W, H = ASR_WINDOW, ASR_HOP
    audio = synthetic_audio(HOUR_SAMPLES, seed=0, device=dev)
    na = stream_frame_count(HOUR_SAMPLES, W, H)
    if na != HOUR_FRAMES:
        raise AssertionError(f"{na} frames in an hour, expected "
                             f"{HOUR_FRAMES}")
    mel, both = ("logmel",), ("filtered", "logmel")
    asr_out, asr_launches = {}, {}
    runs = [  # (tag, stream config, resident depth or None, entry)
        ("stream B=32", StreamConfig(window=W, hop=H, batch_windows=32,
                                     graph="asr", outputs=mel), None,
         "stream"),
        ("stream B=512", StreamConfig(window=W, hop=H, batch_windows=512,
                                      graph="asr", outputs=mel), None,
         "stream"),
        ("stream B=512 +filtered", StreamConfig(
            window=W, hop=H, batch_windows=512, graph="asr", outputs=both),
         None, "stream"),
        ("host-framed B=32", StreamConfig(
            window=W, hop=H, batch_windows=32, graph="asr", outputs=mel,
            framing="host"), None, "frames"),
        ("resident B=32", StreamConfig(window=W, hop=H, batch_windows=32,
                                       graph="asr", outputs=mel), 4,
         "ring"),
        ("resident B=512 +filtered", StreamConfig(
            window=W, hop=H, batch_windows=512, graph="asr", outputs=both),
         4, "ring"),
    ]
    for tag, cfg, depth, entry in runs:
        if depth is None:
            runner = BiosignalStream(asr_app, cfg)
            want = -(-na // cfg.batch_windows)
        else:
            runner = ResidentStream(asr_app, cfg, ResidentConfig(
                ring_depth=depth, drain_interval=4))
            want = -(-na // (depth * cfg.batch_windows))
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)

        def run():
            t0.record()
            out = runner.process(audio)
            t1.record()
            return out

        out, got = counted(run)
        expect_launches(f"asr {tag}", got, {("asr_graph", entry): want})
        if depth is not None and runner.last_drains[-1] != na:
            raise AssertionError(f"asr {tag}: drained "
                                 f"{runner.last_drains[-1]} != {na}")
        ms = t0.elapsed_time(t1)
        rates[f"asr {tag}"] = na / (ms / 1e3)
        asr_launches[tag] = want
        asr_out[tag] = out
        print(f"ASR {tag}: {na} frames in {ms:.1f} ms = "
              f"{rates[f'asr {tag}']:.0f} frames/s, {want} {entry} launches "
              f"[{kind}; {card}]")
    one, got = counted(lambda: graph_pipeline_stream(
        "asr", asr_app, audio, window=W, hop=H, outputs=mel))
    expect_launches("asr graph_pipeline_stream", got,
                    {("asr_graph", "stream"): 1})
    asr_out["one call"] = one
    ref = asr_out["stream B=32"]
    for tag, out in asr_out.items():
        for k, v in out.items():
            if v.shape[0] != na:
                raise AssertionError(f"asr {tag}/{k}: {v.shape[0]} rows")
        check_equal(f"asr {tag} == stream B=32", {"logmel": out["logmel"]},
                    ref)
    check_equal("asr resident == stream, filtered",
                asr_out["resident B=512 +filtered"],
                asr_out["stream B=512 +filtered"])
    # every row of every run against the plain version, in slices
    worst = 0.0
    for f0 in range(0, na, 8192):
        f1 = min(na, f0 + 8192)
        plain = graph_stream_plain(audio[f0 * H: (f1 - 1) * H + W], asr_ops,
                                   graph=asr_graph, window=W, hop=H,
                                   outputs=both)
        for tag, out in asr_out.items():
            worst = max(worst, check_asr(
                f"asr {tag} frames {f0}:{f1}",
                {k: v[f0:f1] for k, v in out.items()},
                {k: plain[k] for k in out}))
        del plain
    max_err["asr main"] = worst
    print(f"ASR main path vs plain on the card: all {na} rows of the "
          f"{len(asr_out)} runs (incl. one graph_pipeline_stream call), "
          f"filtered bitwise, logmel max |diff| {worst:.3e}; stream == "
          f"framed == ring == resident == one call bitwise")
    # the kernel-at-a-time baseline over the same hour
    t_st = time.perf_counter()
    staged, got = counted(lambda: asr_staged(asr_app, audio, window=W,
                                             hop=H))
    staged_s = time.perf_counter() - t_st
    expect_launches("asr_staged", got, {("fir", "rows"): 1,
                                        ("fft", "rows"): 1})
    fused = asr_out["stream B=512 +filtered"]
    err_st = check_asr("asr_staged vs fused", staged, fused)
    max_err["asr_staged"] = err_st
    staged_launches = {"fir": got["fir"]["rows"], "fft": got["fft"]["rows"]}
    rates["asr_staged"] = na / staged_s
    print(f"asr_staged over the hour: {staged_s * 1e3:.1f} ms wall = "
          f"{rates['asr_staged']:.0f} frames/s, 1 FIR + 1 FFT launch; "
          f"filtered bitwise, logmel max |diff| {err_st:.3e} against the "
          f"fused path [{kind}; {card}]")
    del staged, asr_out, fused, one, ref
    # the biosignal kernel-at-a-time baseline over the day's frames
    day_frames = frame_signal(sig, WINDOW, HOP)
    bst, got = counted(lambda: pipeline_staged(
        day_frames, app.fir_taps, app.svm_w, app.svm_b))
    expect_launches("pipeline_staged", got, {("fir", "rows"): 1,
                                             ("fft", "rows"): 1})
    bplain = app(day_frames)
    max_err["pipeline_staged"] = check_close(
        "pipeline_staged vs the staged app",
        {k: bst[k] for k in ("filtered", "features", "margin")},
        {k: bplain[k] for k in ("filtered", "features", "margin")})
    agree = float((bst["class"] == bplain["class"]).float().mean())
    margin_min = float(bplain["margin"].abs().min())
    print(f"pipeline_staged over the day ({n} x {WINDOW}, 11 taps): 1 FIR "
          f"+ 1 FFT launch, max |diff| {max_err['pipeline_staged']:.3e} "
          f"against BiosignalApp, class agreement {agree:.6f}, smallest "
          f"|margin| {margin_min:.3e}")
    if agree != 1.0:
        flips = (bst["class"] != bplain["class"]).nonzero().flatten()
        raise AssertionError(
            f"pipeline_staged class agreement {agree}: windows "
            f"{flips[:5].tolist()} flip at margins "
            f"{bplain['margin'][flips[:5]].tolist()}")
    del bst, bplain, day_frames

    # the FFT at the shape asr_staged gives it, the hour's (359,997 x 256)
    # packed halves, in float32 and bfloat16: held to the plain version,
    # and what a conjugated first stage would read there (before any
    # timing, so that a run that cannot see a wrong kernel times nothing)
    zr = torch.randn(na, W // 2, device=dev)
    zi = torch.randn(na, W // 2, device=dev)
    fft_path = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        xr, xi = zr.to(dtype), zi.to(dtype)
        got = fft_cuda(xr, xi)
        want = fft_plain(xr, xi)
        err = max(check_scaled(f"fft {name} at the path's shape", a, b,
                               FFT_TOL[name]) for a, b in zip(got, want))
        fft_path[name] = {
            "max_abs_err": err, "ratio": scaled_ratio(got, want),
            "wrong_reading": check_wrong_fft(
                f"fft {name} at the path's shape", xr, xi, want, False)}
        del got, want, xr, xi
    max_err["fft path"] = fft_path
    print(f"FFT at the path's shape ({na} x {W // 2}) vs plain: " + "; ".join(
        f"{k} max |diff| {v['max_abs_err']:.3e}, max |diff| / max |plain| "
        f"{v['ratio']:.3e}, a conjugated first stage reads "
        f"{v['wrong_reading']:.3e}" for k, v in fft_path.items())
        + f" (tol {FFT_TOL}, flagged in both)")

    # ---- phase D: 16-bit, integer and 8-bit signals through both graphs
    report["phase_d"] = phase_d(dev, card, app, sig, asr_app, audio)
    # ---- phase K: the FFT past 8192 points, the FIR past 64 taps
    report["phase_k"], k_kernels = phase_k(dev, card, sig)

    # ---- phase S: the standalone shuffle, RoPE and attention entries
    std_cases, std_launches = standalone_path(audio, dev, card)

    # ---- phase 5: per-kernel times beside the bound and the plain time
    kernels, wide = [], {}
    chunk8 = sig[: ring_chunk_samples(WINDOW, HOP, 8)]
    frames8 = frame_signal(chunk8, WINDOW, HOP)
    ring8 = sig[: 3 * 8 * HOP + ring_chunk_samples(WINDOW, HOP, 8)] \
        .as_strided((4, ring_chunk_samples(WINDOW, HOP, 8)), (8 * HOP, 1))
    cases = {
        # name: (kernel fn, plain fn, frames 0..n of the day, input samples)
        "stream": (lambda: graph_stream_call(chunk8, operands, graph=graph,
                                             window=WINDOW, hop=HOP,
                                             outputs=feat),
                   lambda: graph_stream_plain(chunk8, operands, graph=graph,
                                              window=WINDOW, hop=HOP,
                                              outputs=feat),
                   8, chunk8.numel()),
        "frames": (lambda: graph_frames_call(frames8, operands, graph=graph,
                                             outputs=feat),
                   lambda: graph_frames_plain(frames8, operands, graph=graph,
                                              outputs=feat),
                   8, frames8.numel()),
        "ring": (lambda: graph_ring_call(ring8, operands, graph=graph,
                                         window=WINDOW, hop=HOP,
                                         outputs=feat),
                 lambda: graph_ring_plain(ring8, operands, graph=graph,
                                          window=WINDOW, hop=HOP,
                                          outputs=feat),
                 32, 3 * 8 * HOP + ring_chunk_samples(WINDOW, HOP, 8)),
    }
    for entry, (kfn, pfn, nf, nin) in cases.items():
        ms = event_ms(kfn, 200)
        pms = event_ms(pfn, 10)
        wall = host_ms(kfn, 200)
        nbytes, ops = graph_work(nf, nin, feat, cand_cum[nf], ext_cum[nf])
        bms, by = bound_ms(nbytes, ops)
        report.setdefault("wall_ms_per_call", {})[f"biosignal {entry}"] = wall
        kernels.append({
            "name": f"biosignal_graph[{entry}]", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES[entry],
            "launches": launches["B=8 no-filtered"] if entry == "stream"
            else launches[entry],
            "max_abs_err": max(max_err[entry], max_err["main"])
            if entry == "stream" else max_err[entry], "ms": ms,
            "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "library_ms": None})
        print(f"time biosignal {entry}: {nf} frames (main-path dispatch, "
              f"features+margin+class) kernel {ms:.4f} ms device, "
              f"{wall:.4f} ms per call with the wrapper, plain {pms:.3f} ms, "
              f"bound {bms:.6f} ms ({by}) [{card}]")
    # the same kernel at wider dispatches (no JSON entry: PERF.md reads it)
    for label, x, nf, sel in (
            ("stream B=512", sig[: ring_chunk_samples(WINDOW, HOP, 512)],
             512, feat),
            ("stream whole day", sig, n, feat),
            ("stream whole day +filtered", sig, n, OUTPUTS)):
        ms = event_ms(lambda: graph_stream_call(
            x, operands, graph=graph, window=WINDOW, hop=HOP, outputs=sel),
            20)
        nbytes, ops = graph_work(nf, x.numel(), sel, cand_cum[nf],
                                 ext_cum[nf])
        bms, by = bound_ms(nbytes, ops)
        wide[f"biosignal {label}"] = {"frames": nf, "ms": ms,
                                      "bound_ms": bms, "bound_by": by}
        print(f"time biosignal {label}: {nf} frames kernel {ms:.4f} ms, "
              f"bound {bms:.5f} ms ({by}), {nf / (ms / 1e3):.0f} windows/s "
              f"[{card}]")

    # the ASR graph at the main path's dispatch (B=32; the ring 4 x 32);
    # its bound counts the mel product over this filterbank's nonzeros
    mel_nnz = int((asr_app.mel_weights != 0).sum())
    report["mel_nnz"] = mel_nnz
    print(f"mel filterbank: {mel_nnz} nonzero weights of "
          f"{asr_app.mel_weights.numel()}")
    span32 = ring_chunk_samples(W, H, 32)
    chunk32 = audio[:span32]
    frames32 = frame_signal(chunk32, W, H)
    ring32 = audio[: 3 * 32 * H + span32].as_strided((4, span32),
                                                     (32 * H, 1))
    kw = dict(graph=asr_graph, outputs=mel)
    acases = {
        "stream": (lambda: graph_stream_call(chunk32, asr_ops, window=W,
                                             hop=H, **kw),
                   lambda: graph_stream_plain(chunk32, asr_ops, window=W,
                                              hop=H, **kw),
                   32, chunk32.numel(), "stream B=32"),
        "frames": (lambda: graph_frames_call(frames32, asr_ops, **kw),
                   lambda: graph_frames_plain(frames32, asr_ops, **kw),
                   32, frames32.numel(), "host-framed B=32"),
        "ring": (lambda: graph_ring_call(ring32, asr_ops, window=W, hop=H,
                                         **kw),
                 lambda: graph_ring_plain(ring32, asr_ops, window=W, hop=H,
                                          **kw),
                 128, 3 * 32 * H + span32, "resident B=32"),
    }
    for entry, (kfn, pfn, nf, nin, run_tag) in acases.items():
        ms = event_ms(kfn, 200)
        pms = event_ms(pfn, 10)
        wall = host_ms(kfn, 200)
        bms, by = bound_ms(*asr_graph_work(nf, nin, mel, mel_nnz))
        report.setdefault("wall_ms_per_call", {})[f"asr {entry}"] = wall
        kernels.append({
            "name": f"asr_graph[{entry}]", "route": "cuda",
            "source": ASR_SOURCE, "replaces": REPLACES[entry] + ASR_STAGES,
            "launches": asr_launches[run_tag],
            "max_abs_err": max(max_err[f"asr_graph[{entry}]"],
                               max_err["asr main"]),
            "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None})
        print(f"time asr {entry}: {nf} frames (main-path dispatch, logmel) "
              f"kernel {ms:.4f} ms device, {wall:.4f} ms per call with the "
              f"wrapper, plain {pms:.3f} ms, bound {bms:.6f} ms ({by}) "
              f"[{card}]")
    for label, x, nf, sel in (
            ("stream B=512", audio[: ring_chunk_samples(W, H, 512)], 512,
             mel),
            ("stream whole hour", audio, na, mel),
            ("stream whole hour +filtered", audio, na, both)):
        ms = event_ms(lambda: graph_stream_call(
            x, asr_ops, graph=asr_graph, window=W, hop=H, outputs=sel), 10)
        bms, by = bound_ms(*asr_graph_work(nf, x.numel(), sel, mel_nnz))
        wide[f"asr {label}"] = {"frames": nf, "ms": ms, "bound_ms": bms,
                                "bound_by": by}
        print(f"time asr {label}: {nf} frames kernel {ms:.4f} ms, bound "
              f"{bms:.5f} ms ({by}), {nf / (ms / 1e3):.0f} frames/s "
              f"[{card}]")

    # the hour end to end, warm, both outputs: the kernel-at-a-time
    # baseline against one fused call (host clock, synchronised)
    for label, fn, reps in (
            ("fused one call", lambda: graph_pipeline_stream(
                "asr", asr_app, audio, window=W, hop=H, outputs=both), 5),
            ("asr_staged", lambda: asr_staged(asr_app, audio, window=W,
                                              hop=H), 3)):
        ms = host_ms(fn, reps)
        wide[f"asr hour warm {label}"] = {"frames": na, "wall_ms": ms}
        print(f"time asr hour warm, filtered+logmel, {label}: {ms:.3f} ms "
              f"wall per call, {na / (ms / 1e3):.0f} frames/s [{card}]")

    # the FIR and the FFT at the shapes asr_staged gives them: the hour's
    # (359,997 x 512) frames, 2 taps; its (359,997 x 256) packed halves
    hour_frames = frame_signal(audio, W, H)
    taps2 = asr_app.fir_taps
    got = fir_cuda(hour_frames, taps2)
    fir_err = check_scaled("fir at the path's shape", got,
                           fir_plain(hour_frames, taps2), FIR_TOL)
    k = taps2.shape[0]
    wconv = taps2.flip(0).reshape(1, 1, k)
    padded = F.pad(hour_frames, (k - 1, 0)).unsqueeze(1)   # left-padded
    lib = F.conv1d(padded, wconv).squeeze(1)
    lib_err = float((lib - got).abs().max())
    del got, lib
    zc = torch.complex(zr, zi)
    gr, gi = fft_cuda(zr, zi)
    lib_fft_err = float(max((torch.fft.fft(zc).real - gr).abs().max(),
                            (torch.fft.fft(zc).imag - gi).abs().max()))
    del gr, gi
    rows = [
        ("fir", FIR_SOURCE, FIR_REPLACES, "rows",
         lambda: fir_cuda(hour_frames, taps2),
         lambda: fir_plain(hour_frames, taps2),
         lambda: F.conv1d(padded, wconv),
         fir_work(na, W, k, 4), max(max_err["fir[rows]"], fir_err)),
        ("fft", FFT_SOURCE, FFT_REPLACES, "rows",
         lambda: fft_cuda(zr, zi), lambda: fft_plain(zr, zi),
         lambda: torch.fft.fft(zc), fft_work(na, W // 2, 4),
         max(max_err["fft[rows]"], fft_path["float32"]["max_abs_err"])),
    ]
    for name, src, rep, entry, kfn, pfn, lfn, work, err in rows:
        ms = event_ms(kfn, 20)
        pms = event_ms(pfn, 3)
        lms = event_ms(lfn, 20)
        bms, by = bound_ms(*work)
        kernels.append({
            "name": f"{name}[{entry}]", "route": "cuda", "source": src,
            "replaces": rep, "launches": staged_launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": bms,
            "bound_by": by, "library_ms": lms})
        print(f"time {name}: {na} rows at the asr_staged shape, kernel "
              f"{ms:.4f} ms, plain {pms:.3f} ms, library {lms:.4f} ms, "
              f"bound {bms:.5f} ms ({by}) [{card}]")
    # the FFT in bfloat16 at the same shape: half the bytes, no library
    # call (torch.fft.fft takes no bfloat16); no JSON entry
    zr16, zi16 = zr.bfloat16(), zi.bfloat16()
    ms = event_ms(lambda: fft_cuda(zr16, zi16), 20)
    pms = event_ms(lambda: fft_plain(zr16, zi16), 3)
    bms, by = bound_ms(*fft_work(na, W // 2, 2))
    wide["fft bfloat16 asr_staged shape"] = {
        "rows": na, "ms": ms, "plain_ms": pms, "bound_ms": bms,
        "bound_by": by}
    print(f"time fft bfloat16: {na} rows at the asr_staged shape, kernel "
          f"{ms:.4f} ms, plain {pms:.3f} ms, bound {bms:.5f} ms ({by}) "
          f"[{card}]")
    del zr16, zi16
    print(f"library agreement: conv1d (cudnn, TF32 off) vs the FIR kernel "
          f"max |diff| {lib_err:.3e}; torch.fft.fft vs the FFT kernel max "
          f"|diff| {lib_fft_err:.3e}")
    # the FIR and FFT at the biosignal staged shapes, beside one PyTorch
    # call each (conv1d over the left-padded frames, torch.fft.fft); no
    # JSON entry
    day_frames = frame_signal(sig, WINDOW, HOP)
    seg = day_frames[:, :FFT].contiguous()
    zr2, zi2 = seg[:, 0::2].contiguous(), seg[:, 1::2].contiguous()
    zc2 = torch.complex(zr2, zi2)
    w11 = app.fir_taps.flip(0).reshape(1, 1, -1)
    padded11 = F.pad(day_frames, (w11.shape[-1] - 1, 0)).unsqueeze(1)
    for label, fn, lfn, work in (
            ("fir pipeline_staged (10,797 x 2048, 11 taps)",
             lambda: fir_cuda(day_frames, app.fir_taps),
             lambda: F.conv1d(padded11, w11), fir_work(n, WINDOW, 11, 4)),
            ("fft pipeline_staged (10,797 x 256)",
             lambda: fft_cuda(zr2, zi2), lambda: torch.fft.fft(zc2),
             fft_work(n, FFT // 2, 4))):
        ms = event_ms(fn, 50)
        lms = event_ms(lfn, 50)
        bms, by = bound_ms(*work)
        wide[label] = {"ms": ms, "library_ms": lms, "bound_ms": bms,
                       "bound_by": by}
        print(f"time {label}: kernel {ms:.4f} ms, library {lms:.4f} ms, "
              f"bound {bms:.5f} ms ({by}) [{card}]")
    del zc2, padded11

    # the FFT past 8192 points and the FIR past 64 taps (phase K)
    kernels += k_kernels
    # the standalone kernels at phase S's shapes (rows 7-9)
    report["dropped_tile"] = {key: c["dropped_tile"]
                              for key, c in std_cases.items()
                              if "dropped_tile" in c}
    report["one_product"] = {key: c["one_product"]
                             for key, c in std_cases.items()
                             if "one_product" in c}
    kernels += standalone_times(std_cases, max_err, card)
    del std_cases

    # ---- phase 6: kernels and the entries that launched them
    cl = columns["launches"]
    print(f"kernels: {SOURCE} (cuda) launched by frames "
          f"({launches['frames']}), stream ({launches['B=8 no-filtered']}), "
          f"ring ({launches['ring']}), pipeline_stream_sharded "
          f"({cl['pipeline_stream_sharded']}), pipeline_sharded "
          f"({cl['pipeline_sharded']}), the 4-column stream (stream "
          f"{cl['stream n_columns=4']}, frames "
          f"{cl['stream n_columns=4 host-framed']}) and "
          f"FaultTolerantColumnRunner (batch {cl['runner batch']}, after a "
          f"kill {cl['runner batch kill']}, resident "
          f"{cl['runner resident kill']}); {ASR_SOURCE} (cuda) by frames "
          f"({asr_launches['host-framed B=32']}), stream "
          f"({asr_launches['stream B=32']}), ring "
          f"({asr_launches['resident B=32']}); {FIR_SOURCE} and "
          f"{FFT_SOURCE} (cuda) by asr_staged ({staged_launches['fir']}, "
          f"{staged_launches['fft']}) on the main-path runs; "
          f"{FFT_SOURCE} (cuda, the four-step's two launches) by fft and "
          f"rfft ({report['phase_k']['runs']['fft']['launches']}) and "
          f"{FIR_SOURCE} (cuda, {K_FIR_TAPS} taps) by fir "
          f"({report['phase_k']['runs']['fir']['launches']}) on phase K; "
          f"{SHUFFLE_SOURCE} (cuda) by shuffle ("
          + ", ".join(f"{e} {n}" for e, n in std_launches["shuffle"].items())
          + f"); {ROPE_SOURCE} (cuda) by rope ("
          + ", ".join(f"{e} {n}" for e, n in std_launches["rope"].items())
          + f"); {FLASH_SOURCE} (cuda) by flash_attention "
          f"({std_launches['flash_attention']['attention']}) on phase S")
    for kernel, entries in std_launches.items():
        if not all(entries.values()):
            raise AssertionError(f"{kernel}: an entry launched no kernel on "
                                 f"phase S: {entries}")
    # ---- phase L: LM serving at qwen1.5-0.5b's full width
    lm, lm_launches = counted(lambda: lm_path(dev, card))
    if any(n for entries in lm_launches.values() for n in entries.values()):
        raise AssertionError(f"phase L launched a kernel: {lm_launches}")
    print("phase L: no kernel of the port launched (the LM path calls none, "
          "as the reference's calls no Pallas kernel)")
    report["lm"] = lm
    gc.collect()
    torch.cuda.empty_cache()
    # ---- phase P: paged KV, the supervised engines, the front-end
    report["phase_p"] = phase_p(dev, card, app)
    gc.collect()
    torch.cuda.empty_cache()
    # ---- phase M: the other model families at full width
    report["phase_m"] = phase_m(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    # ---- phase T: training at full width
    report["phase_t"] = phase_t(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    # ---- phase U: autotuning on the card at the main path's shapes
    report["phase_u"] = phase_u(dev, card, app, asr_app, sig, audio)
    # ---- phase E: the paper's application end to end
    report["phase_e"] = phase_e(dev, card)
    # ---- phase Q: the quickstart and ASR front-end entries; the mesh
    report["phase_q"] = phase_q(dev, card)
    report["mesh"] = mesh_check(dev, card)
    # ---- phase R: the multi-rank substrate on one card
    report["phase_r"] = phase_r(
        dev, card, report["phase_t"]["T1"]["time"]["device_busy_ms"],
        report["phase_t"]["T1"]["time"])
    for k in kernels:
        if k["name"] == "asr_graph[stream]":
            k["launches_phase_p"] = report["phase_p"]["frontend"][
                "launches"]["asr_graph"]["stream"]
    report.update({"card": card, "kind": kind, "rates": rates,
                   "launches": launches, "columns": columns,
                   "asr_launches": asr_launches,
                   "standalone_launches": std_launches,
                   "kernels": kernels, "wide": wide, "max_abs_err": max_err,
                   "per_frame": {"candidates": cand_cum[n] / n,
                                 "extrema": ext_cum[n] / n}})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
