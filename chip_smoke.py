#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    PYTHONPATH=src python3 chip_smoke.py

    PYTHONPATH=src python3 chip_smoke.py --calls   # B2/B5 alone (below)

    PYTHONPATH=src python3 chip_smoke.py --serves  # profiled serves alone

    PYTHONPATH=src python3 chip_smoke.py --families  # 2n and 3h alone

    PYTHONPATH=src python3 chip_smoke.py --dryrun    # phase 6 alone

Phases, each printed as one JSON object per line:

  1. build    compile every CUDA kernel from ``src/repro_torch/kernels/csrc``,
              with each kernel's registers and spills from ptxas
  2. kernels  B2/B5 (bdmm, bdmm_q) at their call sets first: both stages
              of a 128-block decode layer, of the 4096 x 4096 128-block
              pair and of nemotron-4-15b's, codeqwen1.5-7b's and
              gemma2-27b's staged feed-forward projections, bf16 x, fp32 /
              int8 / int4 weights (gemma2's B2 also with fp32 x), T = 8
              and 512, each line with both stages' launches
              (kernels/bdmm.py:bdmm_geometry), two launches torch.equal and
              B5 torch.equal to B2 on the dequantized blocks (``--calls``
              stops after these and the 128-block serves' profiled windows,
              so that an older checkout can be timed in the same call);
              then each kernel against its plain PyTorch version at the
              serving path's shapes, with its time, the plain version's
              time, one
              PyTorch library call's time and the card's bound (each time
              the median of 5 runs of 20 launches as the host issues them,
              with its spread, and ``card_ms``: the same loops issued while
              the card is held busy, the card's own time); the quantized
              kernels (int8/int4 factors, int8 pages) also bitwise against
              the float kernels on the dequantized inputs (the span
              kernel also at head dims 20 and 256, its other staging
              paths); each Monarch
              line with its launch (blocks, tile, slab); a summary of one
              decode layer at T = 8, with B1/B4 also at T = 512 and their
              device time from torch.profiler; and B1's device time at
              decode with its grid of one block a q-block against one cut
              into slabs to put a block on every SM; each span-kernel line
              with its launch (query tile, pages a split, splits, blocks;
              kernels/paged.py:span_geometry) and two launches on the same
              inputs torch.equal (the cross-block merge is deterministic);
              the span kernel's decode and prefill calls at other pages a
              split (1, 2, 4, 8, unsplit); B2/B5 at ragged and odd shapes
              through both instances; and B2's call sets at other lanes a
              row, diagonal blocks a tile and instance (bdmm_geometry);
              X3, the token draw (sample_tokens: a threefry Gumbel draw
              at temperature > 0, else argmax, and the key split), its
              noise and tokens torch.equal to its plain version at
              gpt2-medium's and nemotron-4-15b's vocabularies, and its
              block draw (sample_block: one key for the whole (8, Vp)
              block, the legacy ServeEngine's) likewise; B1/B4 over a
              mixture-of-experts layer's stacked experts (2m: one launch
              a projection, the expert a second grid axis) at
              qwen2-moe-a2.7b's and granite-moe-1b-a400m's expert call
              sets, decode and prefill rows, bf16 and fp32 x, each
              torch.equal to a loop of single-expert launches, B4 bitwise
              B1 on the dequantized factors; B1 and B2 at the shapes of
              phase 3h's configs (2n: odd block widths, block counts that
              are no power of two, internvl2-76b's staged pairs), T = 8
              and 512, bf16 and fp32 x (B1 also bf16 factors) against
              their plain versions (``--families`` runs 2n and 3h alone)
  3. serve    gpt2-medium at full width (24 layers, published bf16 dtype,
              seeded random weights) served by the continuous-batching
              engine through the Monarch and paged-attention kernels, each
              step a replay of its span bucket's CUDA graph (captures and
              replays printed; one replay of each bucket torch.equal to an
              eager step on the same inputs and a cloned pool, float and
              int8 pools); then
              the same path with 128 Monarch blocks, whose intermediate is
              too wide for the fused kernel, through the staged bdmm branch;
              then the compressed decode path (fused QKV, int8 factors,
              int8 KV pages) through the quantized kernels: quantization on
              the card against the CPU, a profiled serve, an int4 serve and
              a 128-block int8 serve through the staged bdmm_q branch; both
              128-block serves with a profiled window (B2/B5 device ms a
              step).  Before it, the int8 KV write (quantize_kv_write, one
              call of three launches) torch.equal to its plain version on
              the card, pages and scales, at S = 1, 64 and 512, KV 16 x hd
              64 and KV 8 x hd 128, bf16 and fp32 rows.  Every profiled
              window (a warmed engine: no capture inside it) counts the host
              syncs a step (1.0, a copy-on-write window too), the host's own
              ms a step with the card idle, and each kernel's launches a
              step as torch.profiler sees them against the launch counters
              (``--serves`` stops after the float and quantized serves and
              their windows, so that an older checkout can be timed in the
              same call)
  3c. gqa     nemotron-4-15b at full width (32 layers, 48 query heads
              over 8 KV heads, hd 128, vocab 256000, seeded random
              weights), the card's first GQA serve: B3/B6 at its decode
              call set against their plain versions and SDPA; the float
              serve (B1, B2 staged, B3) and an int8 serve (int8 factors,
              K and V fused, int8 KV pages: B4, B5, B6, X2), each with its
              replays torch.equal to eager steps and a profiled window;
              then one greedy ServeEngine generate (B = 8, prompt 64, 16
              new tokens; the first GQA ring on the card: B1, B2, X3)
  3d. paper   the paper's pipeline: gpt2-medium:dense (fp32, seed 0, full
              width, 8 of its 24 layers) D2S-converted on the card (core/d2s.py: q, k, v, o,
              w1, w2) and on the CPU from the same dense tensors, every
              matrix within D2S_REL_TOL card vs CPU, with the card's
              seconds; the converted model served (B1, B3, X3, graphs)
              with the HBM cost model's calibration; the same serve under
              a step-latency budget of the median decode step measured,
              on the card and on the CPU from the card's factors: the same
              greedy tokens and prefill chunks; on the card again with
              that budget over the calibration's scale; layer 0's converted
              wq pair mapped (SparseMap, DenseMap) and emulated on the
              card's crossbars in float64 (cim/functional.py) against B1
              on 8 rows; one dense nemotron-4-15b layer's wq projected
              card vs CPU; the float serves of phases 3 and 3c priced by
              the HBM cost model (the H100's data-sheet rates) and the CIM
              cost model, each engine's calibration printed; and
              ``python -m repro_torch.examples.quickstart`` and
              ``python -m repro_torch.examples.d2s_convert`` on the card
  3e. ft      fault-tolerant serving of gpt2-medium at full width (bf16,
              seed 0, phase 3's geometry, 768 MiB pool and 8-request
              trace; odd requests sampled at 0.8): snapshots with prefill
              in flight (step 2) and decoding (step 12), full and host
              state only, saved under ``build/`` and continued by a new
              engine through ``restore_latest`` (float; then int8
              factors, fused QKV and int8 KV: B4, B6, X2), each with the
              uninterrupted run's tokens and launches a step, its bytes,
              save and restore seconds and the restored engine's graphs;
              a seeded ``FaultInjector.random_schedule`` (pool
              exhaustion, dispatch failure, clock skew, straggle,
              heartbeat silence) with the recovery invariants after every
              step and the unfaulted tokens for every request it did not
              abort; crashes before and after the harvest recovered by an
              ``EngineSupervisor`` from a snapshot published every 4 steps;
              two replicas behind the affinity router (a single engine's
              tokens, affinity hits), replica 1 killed with a published
              snapshot and without one, the degraded fleet's v2 snapshot
              restored, a poison request quarantined after two kills,
              ``scale_to(3)`` then ``scale_to(1)``, the fleet invariants
              every step; readings: tokens/s of 1 and 2 replicas at a
              load of 32 requests from the 4 families (64 new tokens
              each, every replica's slots full), timed 1, 2, 2, 1 after a
              warm-up load, both fleets to the same tokens, and the card's
              peak memory of each fleet
  3f. ring    gpt2-medium at full width (bf16, seed 0) through the legacy
              ServeEngine over the ring cache: greedy and sampled (0.8)
              generates at B = 8, prompt 128, 32 new tokens, every decode
              step a replay of the ring's CUDA graph (the replay
              torch.equal to an eager decode_step on a cloned ring,
              decode_step_layerwise torch.equal to decode_step), 144 B1 +
              1 X3 a decode step (counters and torch.profiler), 1 host
              sync a generate; readings: prefill ms, the graph's and the
              layerwise loop's decode step (wall and device ms), tokens/s,
              the _prefill = None baseline at B = 1, and greedy tokens
              against the continuous-batching engine's (bf16: where they
              part and the ring's logit margin there); then ``python -m
              repro_torch.examples.serve_decode`` in-process, the default
              engine and ``--engine legacy``, each report through B1
  3g. moe     qwen2-moe-a2.7b (60 experts in 64 slots, top-4, 4 shared)
              and granite-moe-1b-a400m (32 experts, top-8) at full width
              and depth, bf16, seed 0, served through the step graphs
              (qwen2 also with int8 factors and fused projections), each
              with a profiled window whose launches a layer are checked:
              the experts' projections one expert-batched launch each;
              gemma2-27b at full width and depth (46 layers: sandwich
              norms, local/global windows, softcaps: its attention takes
              the dense gather, its FFN B2) served and profiled likewise;
              then each cut to 2 layers in fp32, card vs CPU: one mixed
              step's MoE routes (the kept experts of every token) compared
              first, a difference allowed only at a printed near tie,
              then its logits within PARITY_REL_TOL, and a greedy trace's
              routes and tokens
  3h. families mamba2-2.7b (64 layers) and zamba2-7b (81: 13 groups of 6
              Mamba layers under one shared attention block, a tail of 3)
              at full width and depth, seeded fp32 weights cast to bf16 as
              the reference's serve step casts them (its stacks do not run
              bf16 activations over fp32 weights), through the legacy
              ServeEngine (B = 8, a 64-token prompt token by token through
              the decode graph, 32 new; greedy and at 0.8): launches a
              generate = an eager step's times its steps, a replay
              torch.equal to an eager decode_step (the Mamba states
              written in place), a profiled decode window, a profiled
              forward at S = 512 with ssd_chunked's device ms, card vs
              CPU fp32 at 2 layers (zamba2: one group and its tail):
              logits, decode logits, states; seamless-m4t-large-v2 (24 +
              24 layers, vocab 256206): enc_out from 8 x 1024 frames, the
              serving steps' prefill logits and the prompt token by token
              with enc_out, 16 greedy tokens, a decode step's device ms
              and its cross-attention K/V recompute's, card vs CPU at 2 +
              2 layers; internvl2-76b (80 layers, d 8192, GQA 64 / 8): a
              prefill with 256 patch embeddings, the continuous-batching
              engine's text serve (B1, B2, B3, X3) with replays
              torch.equal to eager steps and a profiled window, card vs
              CPU at 2 layers; qwen2-moe-a2.7b's dense-attention step run
              twice (the sink page's colliding writes: logits, pages,
              routes torch.equal); the serve_decode example at
              ``--arch mamba2-2_7b``
  3i. train   training on the einsum backend (no kernel launches in the
              phase): gpt2-medium (paper Monarch), granite-moe-1b-a400m
              and mamba2-2.7b at full width cut to 2 layers, fp32, one
              2 x 128 batch of the synthetic corpus, card vs CPU: the
              loss within PARITY_REL_TOL, each gradient leaf within
              TRAIN_GRAD_TOL of its own max |g| (the worst leaf named;
              MoE routes compared first) from one make_train_step step on
              each side (clipping off: the gradients read from the first
              moment), the CPU's on a worker thread while the card trains
              gpt2-medium at full width and depth (24 layers,
              bf16 compute over fp32 masters, remat "full") trained by
              the Trainer for 30 steps on make_batches(vocab 50257, 8 x
              1024) under torch.use_deterministic_algorithms, its loss
              falling, its step-20 checkpoint restored into a fresh
              Trainer giving steps 20-29's losses again; one step under
              remat "full" and "none" each: wall and device ms, tokens/s,
              peak memory, the top 5 device ops; a pallas-backend Monarch
              layer whose factors require grad refusing autograd
              (``--train`` runs the build and this phase alone)
  3j. mesh    training under a (data 2 x model 2) mesh: four gloo ranks
              sharing the card (launch.mesh.run_ranks), the einsum
              backend, no kernel launches: gpt2-medium at full width and
              depth, fp32, 8 x 1024 global batch (each data rank its 4
              rows), each rank's state drawn as its shards
              (init_params(plan=): equal to its slices of the whole
              draw); the first step's loss within PARITY_REL_TOL and
              every leaf of its clipped gradient (read from the first
              moment), put back together, within TRAIN_GRAD_TOL of its
              max |g| of the single-process step on the card; 3 AdamW
              steps (clipping active): metrics
              within PARITY_REL_TOL, the stepped masters and moments
              put back together at tests/test_torch_train.py's limits;
              granite-moe-1b-a400m at full width cut to 2 layers the
              same way (routes first); gpt2-medium bf16 as a reading
              (3 steps: loss, wall and device ms, collectives a step,
              each by kind, axis and operand bytes); each rank's peak
              memory beside the dry run's traced peak of one step of its
              job (a reading); granite's
              Trainer checkpoint saved under the mesh (whole leaves,
              rank 0 writes): every rank's shards restored from it
              torch.equal to the state it saved, and resumed by one
              process, its losses within PARITY_REL_TOL of the mesh
              run's (the two sum in other orders)
              (``--train-mesh`` runs the build and this phase alone)
  4. parity   the same fp32 weights on the card and on the CPU (plain
              versions): one mixed step's logits (eagerly, then 5 replays
              of it captured as a CUDA graph; both sides' distance from
              the same step in float64 on the CPU printed beside, and
              where they part: the residual stream after the embedding
              and after each layer, the final norm, the LM head's input
              and output, card vs CPU and each against float64), then
              greedy tokens of
              three engine traces (plain; a tiny pool that preempts;
              shared prefixes that fork pages copy-on-write); the same
              traces sampled at temperature 0.8 (a token may differ only
              at a near tie, which is printed); again with
              int8 factors; and with int8 factors and int8 KV pages (stored
              pages and scales after one step, and token agreement); then
              nemotron-4-15b at full width cut to 2 layers: one step (with
              its per-layer breakdown, and layer 0 op by op through B3,
              B1 and B2's two stages: each op card vs CPU, each side
              against float64, and each op alone on the card's inputs)
              and a greedy trace; a snapshot of the fp32 plain trace
              after 3 steps taken on the card and continued on the CPU,
              and the reverse, each with the uninterrupted card tokens;
              the fp32 ServeEngine card vs CPU (a prefill's and a decode
              step's logits within PARITY_REL_TOL, greedy tokens
              identical) and against the continuous-batching engine's
              tokens on the plain trace's prompts
  5. tp       tensor parallelism on the one card: B7, the span kernel per
              rank on its heads of the phase-2 pools (tp 2 and 4, float and
              int8 pages), against its plain version and, concatenated,
              ``torch.equal`` to B3/B6 on the whole pool; then TP = 2 ranks,
              one spawned process each, sharing ``cuda:0`` over gloo (NCCL
              refuses two ranks on one device): phase 4's fp32 traces
              (tokens equal to the card's tp = 1, every step's logits within
              PARITY_REL_TOL), the same traces over int8 KV pages (tokens
              >= INT8_KV_TOKEN_AGREEMENT of tp = 1's) and phase 3's bf16
              serve (a reading) with a profiled window; the fp32 traces
              again with int8 and with packed-int4 factors, fused QKV and
              up/gate (prepared whole, then sharded; tokens and counters
              equal to the card's tp = 1 engine with the same options,
              every step's logits within PARITY_REL_TOL), and with int8
              factors over int8 pages (>= INT8_KV_TOKEN_AGREEMENT); every
              rank runs 24 B7 launches and 144 local B1 (96 B4) launches a
              step, no unsharded span launch and no dense fallback; a tp = 1
              snapshot of the fp32 plain trace continued by the two ranks
              (B7), and their tp = 2 snapshot (rank 0 writes the gathered
              pages) continued at tp = 1 on the card (B3), both with the
              uninterrupted tp = 1 tokens
  5e. tp families  every family at tp = 2 on the two ranks, each held to
              its tp = 1 run on the card: granite-moe-1b-a400m (bf16, a
              reading; fp32) and qwen2-moe-a2.7b (fp32; int8 factors with
              fused projections) at full width and depth through the
              engine with expert parallelism (routes, tokens and every
              step's logits; each rank's expert-batched B1/B4 once a
              projection a layer a step over its n_slots / 2 slots, half
              tp = 1's blocks; B7 every layer; no dense fallback), and
              mamba2-2.7b, zamba2-7b and seamless-m4t-large-v2 at fp32
              through the serving steps (tokens, prefill and decode
              logits, the Mamba states put back together; zamba2's
              whole in_proj on B2); collectives a step and each rank's
              peak memory (``--tp-families`` runs the build and 5e alone)
  6. dryrun   the dry run (launch/dryrun.py: one rank's step traced on
              meta tensors under launch/hlo_analysis.count_step) held to
              the steps 3i and 3j ran on the card: the collectives of
              3j's gpt2-medium bf16 step at a shape-only data 2 x model 2
              gloo mesh equal to what every rank of 3j's world counted in
              one step (kind, axis, operand bytes and count); the traced
              peak of 3i's single-process step (8 x 1024, remat "full"
              and "none") within DRYRUN_PEAK_TOL of the step_peak_gb 3i
              read; that step's FLOPs counted on the card equal to those
              counted on meta; its roofline terms at the H100's
              data-sheet rates beside 3i's device ms (a reading)
              (``--dryrun`` runs the build, 3i's step readings, 3j's bf16
              world and this phase alone)

The gloo worlds of 5c, 3j and 5e (spawned ranks, ~2 min each) run in
background threads while this process goes on: 5c's from phase 3 on, 3j's
and then 5e's from 3e on; each phase reads its world's ranks where it
stands above, and all three are joined before 3i.  Nothing runs beside
phases 2 and 5a, whose kernel times fill the summary.

It exits non-zero on the first failed check, and when a rank fails (a
world still running is then stopped).  Each phase ends with its seconds
and the most this process reserved on the card (``phase_seconds``).  The
last lines are the per-kernel summary, the card's name and power limit
from ``nvidia-smi``, and ``{"ok": true, "device": {...}}``.  It needs one
CUDA device and never imports JAX or the reference package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS's workspace as torch.use_deterministic_algorithms needs it (phase
# 3i); on Hopper it is PyTorch's default size, so no other phase changes
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# H100 SXM device memory and bf16 tensor cores (dense): the dry run's
# data-sheet rates, one source for both
from repro_torch.launch.hlo_analysis import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS as BF16_FLOPS_PER_S)
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 without tensor cores
TF32_FLOPS_PER_S = 495e12     # H100 SXM TF32 tensor cores, dense
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py:17-19
# card vs CPU, fp32 logits of one full-width mixed step: both sides sum in
# fp32 in other orders over 24 layers.  Readings on an H100 SXM are 5.5e-7
# to 6.3e-7 relative; 1e-5 leaves a factor 16 over them, while one bf16
# rounding of the activations (2**-8 = 3.9e-3 relative) is 400 times larger
PARITY_REL_TOL = 1e-5
# card vs CPU with int8 KV pages, one full-width mixed step.  The first
# layer's K/V rows differ by ~1e-7 relative before they are quantized, so
# a value at a rounding tie is stored one int8 step apart (a step is 1/127
# of its head's range): that layer's values are held within one step and
# its scales within 1e-5 relative.  Each such step moves the next layer's
# rows by far more than 1e-7, so deeper layers drift further: on the CPU
# alone, one ulp on the embeddings moves the deepest pages by 2 steps,
# their scales by ~5e-3 and the logits by 1.7e-3 relative (chip_smoke
# prints that reference beside the card's reading).  The card read 2.9e-3
# on the logits (H100 SXM); the limit leaves a factor 10 over it.
INT8_KV_SCALE_REL_TOL = 1e-5
INT8_KV_STEP_REL_TOL = 3e-2
# D2S projection card vs CPU (phase 3d): each matrix's monarch_to_dense,
# Frobenius distance relative to ||M||.  Both sides take the leading
# triples in float64 (core/d2s.py) and round the factors to fp32, so they
# differ by that rounding (~1e-7); an fp32 SVD would differ by ~1e-5 at
# 32 x 32 slices that nearly tie
D2S_REL_TOL = 1e-5
# layers of the D2S-converted gpt2-medium (phase 3d): a third of its 24,
# which keeps the run inside its time as phases are added (over 24 layers
# the host's side of the conversion alone takes one to three minutes;
# 12 until phase 3h came)
D2S_LAYERS = 8
# the CPU side of the nemotron-4-15b layer's D2S check: every 16th row of
# (p x s) slices of each matrix (the slices project independently)
D2S_NEMOTRON_CPU_EVERY = 16
# the matrices of that layer D2S converts: wq alone (6144 x 6144).  The
# whole layer (wq, wk, wv, wo, w1, w2) took the card 96-111 s, w1 and w2
# most of it; D2S at every matrix kind stays covered by gpt2-medium's
# converted layers above it
D2S_NEMOTRON_MATMULS = ("wq",)
# the parameterized matmuls D2S converts (paper Fig. 2b)
D2S_MATMULS = ("wq", "wk", "wv", "wo", "w1", "w2")
# the H100 SXM's data-sheet rates that the HBM cost model prices a step
# with (phase 3d): memory GB/s, and the bf16 tensor-core peak in GFLOP/s
HBM_GBPS = HBM_BYTES_PER_S / 1e9
BF16_GFLOPS = BF16_FLOPS_PER_S / 1e9
# greedy tokens over whole traces with int8 KV: the reference's own bar
# for int8 pages (tests/test_kv_quant.py:352)
INT8_KV_TOKEN_AGREEMENT = 0.95
# the serving phases' engine options (8 slots unless a phase says so)
SERVE_KW = dict(max_slots=8, page_size=16, max_len=1024, chunk_size=64,
                use_paged_kernel=True)
# the sampled traces' temperature (phase 4)
SAMPLE_TEMPERATURE = 0.8
# requests of the nemotron-4-15b serves (phase 3c), as gpt2-medium's
NEMOTRON_REQUESTS = 8
# where phase 3e saves its snapshots (build/ is not committed)
FT_DIR = ROOT / "build" / "ft_snapshots"
# the sampled requests' temperature in phase 3e (odd requests; even ones
# are greedy)
FT_TEMPERATURE = 0.8
# FaultInjector(seed).random_schedule(6, max_step=24) with this seed arms
# all five kinds that need no restore harness: pool exhaustion (steps 6
# and 23), dispatch failure (7), clock skew (11), straggle (17) and
# heartbeat silence (22)
FT_FAULT_SEED = 15
# the replica readings' load: 32 requests (twice one engine's 8 slots)
# over 4 prefix families, 64 new tokens each
FT_LOAD_REQUESTS = 32
FT_LOAD_NEW_TOKENS = 64
FT_FAULT_KINDS = ("pool_exhaustion", "dispatch_failure", "clock_skew",
                  "straggle", "heartbeat_silence")
# phase 3f's ServeEngine generates: batch, prompt tokens, new tokens
RING_BATCH = 8
RING_PROMPT = 128
RING_NEW = 32
# phase 3h's ServeEngine generates (mamba2-2.7b, zamba2-7b): batch, prompt
# tokens (token by token through the decode graph), new tokens
SSM_BATCH, SSM_PROMPT, SSM_NEW = 8, 64, 32
# phase 3h's seamless-m4t-large-v2: batch, decoder prompt, new tokens (the
# encoder reads its n_frontend_tokens frames a row)
ENC_BATCH, ENC_PROMPT, ENC_NEW = 8, 16, 16
# phase 3h's internvl2-76b prefill: text tokens a row after its
# n_frontend_tokens patch embeddings
VLM_TEXT = 32
# phase 3i, training (the einsum backend: the kernels have no backward
# pass).  (a) card vs CPU, one train step of each config at full width cut
# to TRAIN_PARITY_LAYERS layers, fp32, batch TRAIN_PARITY_BATCH: the loss
# within PARITY_REL_TOL, each gradient leaf within TRAIN_GRAD_TOL of its
# own max |g| (the gradient sums over the batch's tokens in other orders
# on the two sides, so an element far below its leaf's largest carries
# that sum's rounding); (b) gpt2-medium at full width and depth
TRAIN_PARITY_ARCHS = ("gpt2-medium", "granite-moe-1b-a400m", "mamba2-2.7b")
TRAIN_PARITY_LAYERS = 2
TRAIN_PARITY_BATCH = (2, 128)
TRAIN_GRAD_TOL = 1e-4
TRAIN_DATA = dict(vocab=50257, seq_len=1024, global_batch=8)
TRAIN_CFG = dict(steps=30, peak_lr=3e-3, warmup=5, schedule="wsd",
                 ckpt_every=20, log_every=0)
TRAIN_RESUME_AT = 20
TRAIN_DIR = ROOT / "build" / "train_ckpt"
# phase 6: a traced peak against the card's max_memory_allocated: the
# allocator rounds every block up to 512 B and holds cuBLAS's workspace
DRYRUN_PEAK_TOL = dict(rel=0.10, abs_bytes=512 * 2 ** 20)

KERNELS = ("monarch_fused", "bdmm", "paged_attention_span",
           "monarch_fused_q", "bdmm_q", "paged_attention_span_q",
           "paged_attention_span_sharded", "paged_attention_span_sharded_q",
           "quantize_kv_write", "sample_tokens", "monarch_fused_experts",
           "monarch_fused_q_experts")
# B1/B4 over a mixture-of-experts layer's stacked experts: the reference
# runs the same Pallas kernels under jax.vmap over the expert axis
VMAPPED = {"monarch_fused_experts": "src/repro/models/layers.py:600",
           "monarch_fused_q_experts": "src/repro/models/layers.py:600"}
# the MoE configs of phase 3g and of B1/B4's expert call sets (2m)
MOE_ARCHS = ("qwen2-moe-a2.7b", "granite-moe-1b-a400m")
# quantize_kv_write and sample_tokens replace jnp code that XLA compiles
# into the reference's jitted step, not Pallas kernels
JNP_KERNELS = ("quantize_kv_write", "sample_tokens")
REPLACES = {
    "monarch_fused": "src/repro/kernels/monarch.py:58",
    "bdmm": "src/repro/kernels/bdmm.py:49",
    "paged_attention_span": "src/repro/kernels/paged.py:196",
    "monarch_fused_q": "src/repro/kernels/monarch.py:115",
    "bdmm_q": "src/repro/kernels/bdmm.py:87",
    "paged_attention_span_q": "src/repro/kernels/paged.py:152",
    "paged_attention_span_sharded": "src/repro/kernels/paged.py:240",
    "paged_attention_span_sharded_q": "src/repro/kernels/paged.py:240",
    "quantize_kv_write": "src/repro/core/quant.py:238",
    "sample_tokens": "src/repro/serving/engine.py:119",
    "monarch_fused_experts": "src/repro/kernels/monarch.py:58",
    "monarch_fused_q_experts": "src/repro/kernels/monarch.py:115",
}
SOURCES = {
    "monarch_fused": "src/repro_torch/kernels/csrc/monarch.cu",
    "bdmm": "src/repro_torch/kernels/csrc/bdmm.cu",
    "paged_attention_span": "src/repro_torch/kernels/csrc/paged.cu",
    "monarch_fused_q": "src/repro_torch/kernels/csrc/monarch.cu",
    "bdmm_q": "src/repro_torch/kernels/csrc/bdmm.cu",
    "paged_attention_span_q": "src/repro_torch/kernels/csrc/paged.cu",
    "paged_attention_span_sharded": "src/repro_torch/kernels/csrc/paged.cu",
    "paged_attention_span_sharded_q": "src/repro_torch/kernels/csrc/paged.cu",
    "quantize_kv_write": "src/repro_torch/kernels/csrc/kv_write.cu",
    "sample_tokens": "src/repro_torch/kernels/csrc/sample.cu",
    "monarch_fused_experts": "src/repro_torch/kernels/csrc/monarch.cu",
    "monarch_fused_q_experts": "src/repro_torch/kernels/csrc/monarch.cu",
}
# the profiler's kernel names (substrings) and the launch counters that
# count them: each counted launch of quantize_kv_write is one
# kv_store_kernel (with a memset and two more kernels before it), each of
# sample_tokens one sample_partial_kernel (and one merge after it)
PROFILED = {"monarch_fused_kernel": ("monarch_fused", "monarch_fused_q",
                                     "monarch_fused_experts",
                                     "monarch_fused_q_experts"),
            "bdmm_": ("bdmm", "bdmm_q"),
            "paged_span_kernel": ("paged_attention_span",
                                  "paged_attention_span_q",
                                  "paged_attention_span_sharded",
                                  "paged_attention_span_sharded_q"),
            "kv_store_kernel": ("quantize_kv_write",),
            "sample_partial_kernel": ("sample_tokens",)}
# the least share of a window's counted launches the profiler must show
PROFILED_SHARE = 0.9
# readings of that witness a window may take: torch.profiler drops a
# kernel record now and then (a family with one launch a step then reads
# 7 of 8), so a family short of PROFILED_SHARE is read again over as many
# later steps, and its best reading is the witness: one dropped record
# fails a reading, not the run, while a family whose counted launches do
# not run reads short every time
WITNESS_READINGS = 3
# ranks of the tensor-parallel phase: processes that share the one card
TP = 2
# the longest a timed loop of ``time_ms`` runs: a call slower than this is
# timed alone, one call a loop
TIME_LOOP_MS = 10.0
# phase 5e's MoE engine traces: (requests, shortest and longest prompt,
# seed), greedy, TPF_NEW new tokens each; its serving steps' batch, prompt
# (token by token), new tokens and encoder frames
TPF_PROMPTS = (4, 16, 64, 12)
TPF_NEW = 8
TPF_STEPS = dict(batch=4, prompt=16, new=8, frames=64)
# B1's and B2's call sets at phase 3h's configs (2n): (din, dout) at the
# paper policy; B1 (fused) ...
FAMILY_FUSED = {"mamba2_in_proj_s661": (2560, 10576),
                "mamba2_out_proj_k80": (5120, 2560),
                "zamba2_out_proj_k112": (7168, 3584)}
# ... and B2 (staged), each a list of projections as in BDMM_CALL_SETS
FAMILY_STAGED = {"h_zamba2_in_proj_s911": [(3584, 14576)],
                 "i_zamba2_w2_p112": [(14336, 3584)],
                 "j_internvl2_wq_nb128": [(8192, 8192)],
                 "k_internvl2_w2_k224_q256": [(28672, 8192)]}
# B2/B5's call sets: the projections (din, dout) whose factors take the
# staged branch, their blocks (None: make_dims' paper policy) and how many
# leading projections the quantized decode path fuses into one (B5's
# lines take the fused one)
BDMM_CALL_SETS = {
    # (a) one gpt2-medium decode layer at 128 blocks (B5: QKV fused)
    "a_gpt2_layer_nb128": ([(1024, 1024)] * 4 + [(1024, 4096),
                                                 (4096, 1024)], 128, 3),
    # (b) the 4096 x 4096 pair at 128 blocks
    "b_4096x4096_nb128": ([(4096, 4096)], 128, 0),
    # (c), (d) nemotron-4-15b's FFN (d_model 6144, d_ff 24576)
    "c_nemotron_w1": ([(6144, 24576)], None, 0),
    "d_nemotron_w2": ([(24576, 6144)], None, 0),
    # (e) codeqwen1.5-7b's FFN down projection (d_ff 13440, d_model 4096)
    "e_codeqwen_w2": ([(13440, 4096)], None, 0),
    # (f), (g) gemma2-27b's GeGLU FFN (d_model 4608, d_ff 36864), as phase
    # 3g serves it: w1 and wg (B5: fused into w1g), then w2
    "f_gemma2_w1_wg": ([(4608, 36864)] * 2, None, 2),
    "g_gemma2_w2": ([(36864, 4608)], None, 0),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def bound_ms(n_bytes: float, flops: float, all_bf16: bool,
             peak: float = 0.0) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate, or operations
    over the peak rate of their type (bf16 where every operand is bf16,
    else fp32 outside the tensor cores; ``peak`` where the caller names
    the rate), whichever is larger."""
    if not peak:
        peak = BF16_FLOPS_PER_S if all_bf16 else FP32_FLOPS_PER_S
    tb, tf = n_bytes / HBM_BYTES_PER_S, flops / peak
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def _device_ms(fn, n: int = 10) -> float:
    """Device kernel time of one ``fn()`` from torch.profiler: what the
    card spends, without the host's time to issue the launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum((getattr(e, "self_device_time_total", None)
                or e.self_cuda_time_total) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / n


def _card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


# set when the script ends, so a world still running in the background is
# stopped with it (``launch.mesh.run_ranks(stop=)``)
WORLD_STOP = threading.Event()


def _start_world(pool, fn, ranks: int, jobs: dict, data: int = 1):
    """``run_ranks(fn, ranks)`` over gloo on the card in ``pool``'s thread,
    while this process goes on with other phases: a future of (the ranks'
    results, the world's seconds)."""
    from repro_torch.launch.mesh import run_ranks

    def world():
        if WORLD_STOP.is_set():
            raise RuntimeError("the script ended before the world started")
        t0 = time.perf_counter()
        out = run_ranks(fn, ranks, backend="gloo", device="cuda:0",
                        data=data, args=(jobs,), timeout_s=900,
                        stop=WORLD_STOP)
        return out, time.perf_counter() - t0

    return pool.submit(world)


def _ptxas_report(log: str) -> list:
    """Each kernel's registers and spills from ``nvcc -Xptxas -v``'s
    output, as [mangled name, its spill line, its register line]."""
    out = []
    for ln in log.splitlines():
        if "Function properties for" in ln:
            out.append([ln.split(" for ", 1)[1].strip()])
        elif out and ("spill" in ln or "registers" in ln):
            out[-1].append(ln.replace("ptxas info    :", "").strip())
    return out


def _graphs(eng):
    """The engine's step graphs (None under a mesh, and in an older
    checkout, whose engine has none)."""
    return getattr(eng, "step_graphs", None)


def _warm(eng, vocab: int) -> None:
    """Serve one request at each span bucket up to the chunk size, one at
    a time, with two new tokens each, so that every bucket a later window
    meets is captured before it."""
    import numpy as np

    from repro_torch.serving import SamplingParams

    rng = np.random.default_rng(99)
    S = 1
    while S <= eng.scheduler.cfg.chunk_size:
        eng.add_request(rng.integers(0, vocab, S),
                        SamplingParams(max_new_tokens=2))
        eng.run()
        S *= 2


def _profile_steps(step, n: int, sync) -> dict:
    """torch.profiler's device kernels over ``n`` calls of ``step``, one
    profile a call (a profile of many steps' launches can overflow the
    tracer's buffers and drop kernel records), each ended by ``sync()``:
    kernel name -> (device us, launches), summed over the calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    by_key: dict = {}
    for _ in range(n):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            sync()
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue  # host ops also carry their kernels' device time
            dt = getattr(e, "self_device_time_total", None)
            if dt is None:
                dt = e.self_cuda_time_total
            us, k = by_key.get(e.key, (0.0, 0))
            by_key[e.key] = (us + dt, k + e.count)
    return by_key


def _window(eng, n_steps: int, watch: tuple = ()) -> dict:
    """Where ``n_steps`` engine steps' time goes: wall clock of
    synchronized steps, the span tokens a second, the device's kernel time
    from torch.profiler (with the ms and launches a step of the kernels
    whose names hold each string of ``watch``), each kernel family's
    launches a step as the profiler sees them against the launch
    counters (PROFILED), the host's own ms a step (each step issued with
    the card idle, less the time inside the graph replay and the
    harvest's wait for the card), the graph captures and replays of the
    window, and the host syncs PyTorch's sync debug mode detects."""
    import torch

    from repro_torch.kernels import launches

    g = _graphs(eng)
    graphs0 = (g.captures, g.replays) if g else None
    toks0 = eng.stats["prefill_tokens"] + eng.stats["decode_tokens"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n_steps
    toks = eng.stats["prefill_tokens"] + eng.stats["decode_tokens"] - toks0
    counted0 = launches()
    by_key = _profile_steps(eng.step, n_steps, torch.cuda.synchronize)
    counted = launches()
    rows = sorted(((us / 1e3 / n_steps, key, n)
                   for key, (us, n) in by_key.items()), reverse=True)
    device = sum(r[0] for r in rows)
    watched = {w: [sum(r[0] for r in rows if w in r[1]),
                   sum(r[2] for r in rows if w in r[1]) / n_steps]
               for w in watch}
    # launches a step: the counters (a graph's replay adds its capture's),
    # and the kernels the profiler saw by name, a reading: it can drop a
    # kernel record now and then, eager or replayed (_witness reads again)
    per_step = {c: (counted[c] - counted0.get(c, 0)) / n_steps
                for c in counted if counted[c] != counted0.get(c, 0)}
    profiled = _seen_vs_counted(rows, per_step, n_steps)
    # the host's own time: each step issued with the card idle, less the
    # graph replay's launch and the harvest's wait for the card (the
    # sampled tokens' copy waits for every launch queued before it, the
    # next step's included)
    host, waited, replay0 = 0.0, [0.0], g.replay_s if g else 0.0
    harvest = eng._harvest

    def timed_harvest(entry):
        t2 = time.perf_counter()
        entry["sampled"] = entry["sampled"].cpu()
        waited[0] += time.perf_counter() - t2
        return harvest(entry)
    eng._harvest = timed_harvest
    try:
        for _ in range(n_steps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eng.step()
            host += time.perf_counter() - t1
    finally:
        del eng._harvest
    replay = (g.replay_s - replay0) if g else 0.0
    # calls that make the host wait for the device (PyTorch's sync debug
    # mode warns on each one it detects); the engine means one a step, the
    # harvest's read of the sampled tokens
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(n_steps):
                eng.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sum("called a synchronizing CUDA operation" in str(w.message)
                for w in caught)
    graphs = None
    if g:
        graphs = {"captures": g.captures - graphs0[0],
                  "replays": g.replays - graphs0[1],
                  "replay_host_ms_per_step": replay / n_steps * 1e3,
                  "buckets": g.buckets}
    profiled, readings = _witness(eng, n_steps, profiled)
    out = {"wall_ms_per_step": wall * 1e3,
           "device_ms_per_step": device,
           "device_busy_share": device / (wall * 1e3),
           "tokens_per_s": toks / (wall * n_steps),
           "host_ms_per_step": (host - replay - waited[0]) / n_steps * 1e3,
           "harvest_wait_ms_per_step": waited[0] / n_steps * 1e3,
           "host_syncs_per_step": syncs / n_steps,
           "launches_per_step": per_step,
           "launches_per_step_profiled_vs_counted": profiled,
           "witness_readings": readings,
           "watched_ms_launches_per_step": watched,
           "top_kernels_ms_per_step": [
               [name[:70], ms, n / n_steps] for ms, name, n in rows[:8]]}
    if graphs:
        out["graphs"] = graphs
    return out


def _seen_vs_counted(rows, per_step: dict, n_steps: int) -> dict:
    """Each kernel family's launches a step: [as the profiler saw them
    (``rows`` of (ms, name, launches)), as the counters counted them]."""
    return {name: [sum(r[2] for r in rows if name in r[1]) / n_steps,
                   sum(per_step.get(c, 0) for c in ctrs)]
            for name, ctrs in PROFILED.items()}


def _short(profiled: dict) -> list:
    return [k for k, (seen, counted) in profiled.items()
            if seen < PROFILED_SHARE * counted]


def _witness(eng, n_steps: int, first: dict) -> tuple[dict, int]:
    """The profiler's witness of the counters, ``first`` the window's own
    reading: while a family reads short of ``PROFILED_SHARE``, up to
    ``WITNESS_READINGS`` readings in all, the next ``n_steps`` steps are
    profiled again (each against its own counted launches) and each short
    family keeps its best reading.  Returns (witness, readings taken)."""
    import torch

    from repro_torch.kernels import launches

    def any_short() -> bool:
        # a mesh's ranks step together: every rank reads again when any
        # rank reads short (one all-reduce of a host flag)
        short = float(bool(_short(best)))
        if getattr(eng, "mesh", None) is None:
            return bool(short)
        from repro_torch.sharding.api import all_reduce_sum

        flag = all_reduce_sum(torch.tensor([short], device=eng.mesh.device),
                              eng.mesh)
        return bool(flag.item() > 0)

    best, readings = dict(first), 1
    while readings < WITNESS_READINGS and any_short():
        c0 = launches()
        by_key = _profile_steps(eng.step, n_steps, torch.cuda.synchronize)
        c1 = launches()
        per_step = {c: (c1[c] - c0.get(c, 0)) / n_steps for c in c1}
        rows = [(us, key, n) for key, (us, n) in by_key.items()]
        again = _seen_vs_counted(rows, per_step, n_steps)
        for k in _short(best):
            seen, counted = again[k]
            if seen / max(counted, 1e-9) > best[k][0] / max(best[k][1],
                                                             1e-9):
                best[k] = again[k]
        readings += 1
    return best, readings


def _profile_serve(cfg, params, watch: tuple = (), **engine_kw) -> dict:
    """A warmed engine (:func:`_warm`), then a fresh batch of 8 x 256-token
    prompts: one prefill step, then 8 decode steps once every request is
    decoding (``watch`` as in :func:`_window`).  Under graphs every
    window replays without a capture, its launches a step are those of
    an eager step of its bucket (:func:`_eager_launches`); eager or
    replayed, the profiler shows at least ``PROFILED_SHARE`` of each
    kernel family's counted launches in one of up to ``WITNESS_READINGS``
    readings (:func:`_witness`)."""
    import numpy as np

    from repro_torch.serving import ContinuousBatchingEngine, SamplingParams

    eng = ContinuousBatchingEngine(cfg, params, **{
        **SERVE_KW, "max_slots": 8, **engine_kw})
    _record_inputs(eng)
    _warm(eng, cfg.vocab)
    rng = np.random.default_rng(4)
    for _ in range(8):
        eng.add_request(rng.integers(0, cfg.vocab, 256),
                        SamplingParams(max_new_tokens=64))
    prefill = _window(eng, 1, watch)
    while any(s.request.state.value != "running"
              for s in eng.running.values()):
        eng.step()
    decode = _window(eng, 8, watch)
    # the engine waits on the card once a step (the harvest of the sampled
    # tokens); the span kernel's launch reads no device value on the host
    for name, w in (("prefill", prefill), ("decode", decode)):
        require(w["host_syncs_per_step"] == 1.0,
                f"{name} window: {w['host_syncs_per_step']} host syncs a "
                f"step, not 1")
        # the card's own witness of the counters, eager or replayed: the
        # profiler may drop a record now and then (>= 0.978 of the counted
        # launches in every H100 run so far), so a short family is read
        # again (_witness); a family whose launches do not run stays short
        for kname, (seen, counted) in w[
                "launches_per_step_profiled_vs_counted"].items():
            require(seen >= PROFILED_SHARE * counted,
                    f"{name} window: the profiler shows {seen} {kname} "
                    f"launches a step, the counters {counted}")
        if "graphs" not in w:
            continue  # an older checkout's eager engine
        require(w["graphs"]["captures"] == 0
                and w["graphs"]["replays"] == 4 * (1 if name ==
                                                   "prefill" else 8),
                f"{name} window: every step must replay a captured "
                f"graph: {w['graphs']}")
        eager = _eager_launches(eng, SERVE_KW["chunk_size"]
                                if name == "prefill" else 1)
        w["launches_per_step_eager"] = eager
        require(w["launches_per_step"] == eager,
                f"{name} window: {w['launches_per_step']} launches a step "
                f"under graphs, {eager} in an eager step")
    return {"prefill_T512": prefill, "decode_T8": decode}


def _eager_step(eng, pool, tok, keys, packed, bucket):
    """``_packed_step`` of the engine's step on a pool, chained token and
    keys of the caller's; ``bucket`` is a graph's key: (S, draw), or S in
    an older checkout, whose step has no keys."""
    import torch

    from repro_torch.serving.engine import _packed_step

    buf = torch.from_numpy(packed).to(tok.device)
    if isinstance(bucket, tuple):
        return _packed_step(eng.params, pool, eng.cfg, tok, keys, eng._temp,
                            buf, bucket)
    return _packed_step(eng.params, pool, eng.cfg, tok, buf, bucket)


def _greedy_bucket(eng, S: int):
    """The key of span bucket ``S``'s greedy graph among those the engine
    has seen (S itself in an older checkout)."""
    return next(k for k in _graphs(eng).inputs_seen
                if k == S or k == (S, False))


def _eager_launches(eng, S: int) -> dict:
    """The launches one eager step of span bucket ``S`` (greedy) counts:
    ``_packed_step`` on the bucket's latest packed input, a clone of the
    pool, of the chained token and of the keys."""
    import torch

    from repro_torch import tree_map
    from repro_torch.kernels import launches

    bucket = _greedy_bucket(eng, S)
    packed = _graphs(eng).inputs_seen[bucket]
    pool = tree_map(torch.clone, eng.pool)
    keys = getattr(eng, "_keys", None)
    before = launches()
    _eager_step(eng, pool, eng._tok.clone(),
                None if keys is None else keys.clone(), packed, bucket)
    after = launches()
    return {c: after[c] - before[c] for c in after if after[c] != before[c]}


def _drive(eng, prompts, stagger: int, max_new: int, what: str,
           logits: Optional[list] = None,
           sampling: Optional[tuple[float, int]] = None,
           draws: Optional[dict] = None) -> list:
    """Serve ``prompts`` to the end, one more every ``stagger`` steps (0:
    all at once); returns the requests.  ``logits``: each dispatched
    step's logits of the rows with a span, over the real vocab, on the
    host (read right after the step: a graph's replay overwrites them).
    ``sampling`` (temperature, seed): request i samples from seed + i,
    else greedy; ``draws``: the logits row each (request i, token j) was
    drawn from (the step's sampling rows, before their tokens are read
    back)."""
    import torch

    from repro_torch.serving import SamplingParams

    pending, reqs, steps, index = list(prompts), [], 0, {}
    while pending or eng.has_work():
        if pending and (stagger == 0 or steps % stagger == 0):
            while pending:
                sp = SamplingParams(max_new_tokens=max_new)
                if sampling is not None:
                    sp = SamplingParams(max_new_tokens=max_new,
                                        temperature=sampling[0],
                                        seed=sampling[1] + len(reqs))
                r = eng.add_request(pending.pop(0), sp)
                index[r.req_id] = len(reqs)
                reqs.append(r)
                if stagger:
                    break
        before = eng.stats["mixed_steps"]
        eng.step()
        if eng.stats["mixed_steps"] > before:
            lg = eng.step_logits
            if logits is not None:
                rows = torch.from_numpy(eng.step_rows).to(lg.device)
                logits.append(lg[rows, :eng.cfg.vocab].float().cpu())
            if draws is not None:
                # every earlier step is harvested: token j is this one's
                for slot, seq in eng._pending[-1]["slots"]:
                    j = len(seq.request.output_tokens)
                    if j < max_new:
                        draws[(index[seq.req_id], j)] = \
                            lg[slot, :eng.cfg.vocab].float().cpu()
        steps += 1
        require(steps < 1000, f"{what} did not finish")
    return reqs


def _sampled_flips(toks_a: list, toks_b: list, draws_a: dict,
                   draws_b: dict, temperature: float, seed: int) -> list:
    """Each request whose tokens differ between two runs (a: the card, b:
    the CPU), at its first differing draw j: the margin between the two
    best perturbed scores ``logit / t + gumbel`` of b's logits under the
    draw's key (request i's stream from ``PRNGKey(seed + i)``, split j
    times), and the largest scaled logit difference a - b.  The draw can
    flip only where twice that difference reaches the margin (a near
    tie)."""
    import torch

    from repro_torch.core import prng

    t = torch.tensor(temperature, dtype=torch.float32)
    out = []
    for i, (a, b) in enumerate(zip(toks_a, toks_b)):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        key = prng.prng_key(seed + i)
        for _ in range(j):
            key = prng.split(key)[1]
        la, lb = draws_a[(i, j)], draws_b[(i, j)]
        scores = lb / t + prng.gumbel(prng.split(key)[0], lb.shape[-1])
        top = torch.topk(scores, 2)
        margin = float(top.values[0] - top.values[1])
        diff = float((la - lb).abs().max() / t)
        # the reconstruction's own check: b's draw is b's token
        require(int(top.indices[0]) == b[j],
                f"request {i} token {j}: the draw's key is not reproduced")
        out.append({"request": i, "token": j, "card": a[j], "cpu": b[j],
                    "margin": margin, "max_scaled_logit_diff": diff,
                    "near_tie": 2 * diff >= margin})
    return out


def _layered_mixed_step(params, tokens, start, span_len, page_table, pool,
                        cfg, record) -> "torch.Tensor":
    """``transformer.paged_mixed_step``'s body op for op (the same logits,
    bitwise), handing each stage's output to ``record(name, tensor)``: the
    embedding, each layer's residual stream, the final norm, and the LM
    head's input (the rows it reads).  Returns the (B, Vp) logits."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    x = L.embed(params["embedding"], tokens, cfg, T._dtype(cfg))
    record("embed", x)
    for i, win in enumerate(T.layer_windows(cfg)):
        x = T.attn_block_apply(
            T.layer_params(params["decoder"]["layers"], i), x, cfg,
            window=win, cache=T.layer_params(pool["layers"], i), pos=start,
            page_table=page_table, span_len=span_len)
        record(f"layer_{i}", x)
    x = L.norm_apply(params["ln_f"], x, cfg.norm_type)
    record("final_norm", x)
    idx = (torch.clamp(span_len.long(), min=1) - 1)[:, None, None]
    xl = torch.gather(x, 1, idx.expand(-1, 1, x.shape[-1]))
    record("head_in", xl)
    return L.unembed(params["embedding"], xl, cfg)[:, 0]


def _layer0_ops(p, x, pages, start, span_len, page_table, cfg, window,
                op) -> "torch.Tensor":
    """``transformer.attn_block_apply`` on a paged cache, op by op (the
    same operations, bitwise), each run as ``op(name, fn, *args)``, which
    returns ``fn(*args)``: the norms, each projection (B1), RoPE, the paged
    attention with its page write (B3; the write goes to a copy of
    ``pages``, so that ``args`` stay the op's input), the residual adds,
    and the FFN pair as its two B2 stages each (``ops.monarch_mm``'s staged
    branch), with the squared ReLU between.  For a stack without biases or
    QK norm, with a squared-ReLU FFN whose Monarch factors take the staged
    branch: nemotron-4-15b's."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.linear import linear_apply
    from repro_torch.kernels import ops as K
    from repro_torch.models import layers as L

    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dtype = x.dtype

    def lin(w, a):
        return linear_apply(w, a, backend=cfg.monarch.backend)

    def norm(w, a):
        return L.norm_apply(w, a, cfg.norm_type)

    def rope(a, pos):
        return L.rope(a, pos, cfg.rope_theta)

    def attend(q, k, v, kp, vp, pt, pos, sl):
        cache = {"k_pages": kp.clone(), "v_pages": vp.clone()}
        return L._paged_attend(q, k, v, cache, pt, pos, cfg, window, dtype,
                               span_len=sl)[0]

    def stage1(a, w):
        k, _, pp = w.shape
        return K.bdmm(a.reshape(-1, k * pp).contiguous().view(-1, k, pp), w)

    def stage2(u, w):
        return K.bdmm(u.transpose(-1, -2), w)

    def staged(name, w, a):
        q, s = w["R"].shape[:2]
        u = op(f"{name} stage 1 (B2)", stage1, a, w["L"])
        y = op(f"{name} stage 2 (B2)", stage2, u, w["R"])
        return y.reshape(-1, q * s).reshape(*a.shape[:-1], q * s)

    at, ff = p["attn"], p["ffn"]
    h = op("ln1", norm, p["ln1"], x)
    q = op("wq (B1)", lin, at["wq"], h).reshape(B, S, H, hd)
    k = op("wk (B1)", lin, at["wk"], h).reshape(B, S, KV, hd)
    v = op("wv (B1)", lin, at["wv"], h).reshape(B, S, KV, hd)
    pos = start.reshape(B, 1).long() + torch.arange(S, device=x.device)[None]
    q = op("rope q", rope, q, pos)
    k = op("rope k", rope, k, pos)
    o = op("attention (B3)", attend, q, k, v, pages["k_pages"],
           pages["v_pages"], page_table, pos, span_len)
    a = op("wo (B1)", lin, at["wo"], o.reshape(B, S, H * hd))
    x = op("residual 1", torch.add, x, a)
    h = op("ln2", norm, p["ln2"], x)
    u = staged("w1", ff["w1"], h)
    r = op("squared ReLU", lambda t: torch.square(F.relu(t)), u)
    return op("residual 2", torch.add, x, staged("w2", ff["w2"], r))


def _rel(a, b) -> float:
    """max |a - b| over max |b|, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def _per_layer(card: dict, cpu: dict, fp64: dict) -> dict:
    """Each stage's relative difference card vs CPU fp32 and each side's
    against the float64 witness; the first stage where card and CPU
    differ at all, and the first stage after it whose card-vs-CPU
    difference exceeds twice the stage's before it."""
    names = list(card)
    r = [_rel(card[n], cpu[n]) for n in names]
    return {"stages": names, "card_vs_cpu": r,
            "card_vs_fp64": [_rel(card[n], fp64[n]) for n in names],
            "cpu_vs_fp64": [_rel(cpu[n], fp64[n]) for n in names],
            "first_differs": next((n for n, x in zip(names, r) if x > 0),
                                  None),
            "first_jump": next((names[i] for i in range(1, len(r))
                                if 0 < 2 * r[i - 1] < r[i]), None)}


def _leaf(tree, path: str):
    """The node of a nested dict at a ``keystr`` path (``['a']['b']``)."""
    for key in path[2:-2].split("']['"):
        tree = tree[key]
    return tree


def _timed_steps(eng) -> list:
    """The step numbers of the calibration's pairs: the last ``n`` steps
    that dispatched a span (a step that only harvests prices nothing)."""
    n = eng.calibration.n
    return sorted({s for s, _, _, _ in eng.dispatch_log})[-n:] if n else []


def _chunks(eng) -> list:
    """(step of the calibration's run, tokens) of each prefill chunk."""
    steps = _timed_steps(eng)
    at = {s: i for i, s in enumerate(steps)}
    return [(at[s], n) for s, _, kind, n in eng.dispatch_log
            if kind != "decode" and s in at]


def _calibration(eng) -> dict:
    """A cost model's calibration over a serve's timed steps (n, the
    least-squares scale of measured over predicted ns, the residuals'
    spread), with the median measured ns of the steps that ran decode
    spans only."""
    cal = eng.calibration
    prefill = {s for s, _, kind, _ in eng.dispatch_log if kind != "decode"}
    decode_ns = sorted(m for s, m in zip(_timed_steps(eng), cal.measured)
                       if s not in prefill)
    return {**cal.report(), "decode_steps": len(decode_ns),
            "median_decode_step_ns": (decode_ns[len(decode_ns) // 2]
                                      if decode_ns else None)}


def _checksum(tree) -> float:
    """Sum of every parameter, in float64: equal trees, equal sums."""
    from repro_torch import tree_map

    leaves: list = []
    tree_map(leaves.append, tree)
    return float(sum(t.double().sum() for t in leaves))


def _serve_prompts(vocab: int, n_req: int, lo: int, hi: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
            for _ in range(n_req)]


def _serve(cfg, params, n_req, lo, hi, new_tokens, seed, **engine_kw):
    """A warmed engine (:func:`_warm`, not timed) serves ``n_req`` prompts
    of ``lo`` to ``hi`` tokens, all at once, ``new_tokens`` each: (engine,
    requests, launches, seconds, tokens out, prompt tokens), with each
    bucket's latest packed input kept on the engine's graphs for
    :func:`_replay_vs_eager`."""
    import torch

    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serving import ContinuousBatchingEngine, SamplingParams

    eng = ContinuousBatchingEngine(cfg, params, **{**SERVE_KW, **engine_kw})
    _record_inputs(eng)
    _warm(eng, cfg.vocab)
    # a cost model's calibration pairs: the timed run's steps only
    eng.calibration.predicted.clear()
    eng.calibration.measured.clear()
    prompts = _serve_prompts(cfg.vocab, n_req, lo, hi, seed)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=new_tokens))
            for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launches()
    for r in reqs:
        require(len(r.output_tokens) == new_tokens
                and all(0 <= t < cfg.vocab for t in r.output_tokens),
                "every request returns its tokens, all in the vocab")
    eng.pool_host.check_invariants()
    out = sum(len(r.output_tokens) for r in reqs)
    return eng, reqs, counts, dt, out, sum(len(p) for p in prompts)


def _record_inputs(eng) -> None:
    """Keep each bucket's latest packed host input on the engine's graphs
    (``inputs_seen``), for :func:`_replay_vs_eager` and
    :func:`_eager_launches`."""
    g = _graphs(eng)
    if g is None:
        return
    run, g.inputs_seen = g.run, {}

    def recording(S, packed, upload):
        g.inputs_seen[S] = packed.copy()
        return run(S, packed, upload)
    g.run = recording


def _graph_stats(eng) -> Optional[dict]:
    g = _graphs(eng)
    return None if g is None else {"captures": g.captures,
                                   "replays": g.replays,
                                   "buckets": g.buckets}


def _replay_vs_eager(eng) -> dict:
    """One replay of each captured bucket, on the latest packed input the
    serve gave it, against ``_packed_step`` run eagerly on the same input,
    a clone of the pool, of the chained token and of the keys: the sampled
    tokens, the logits of every row, the token and keys after the step
    and every page and scale ``torch.equal``.  Where the dense gather runs
    (gemma2-27b's softcap, ``paged_kernel=False``) the padding rows'
    colliding writes on the sink page (page 0) all carry the last one's
    value (``models/layers.py:last_writes``), so a row without a span,
    whose query reads the sink, reads the same rows in both, and the sink
    is compared too.  Where the span kernel runs, a float pool's sink is
    left out: the kernel never reads it, and an index_put on the card
    resolves its duplicates in no fixed order (the int8 pool's kernel
    keeps the last, so its sink is compared).  The engine's pool takes
    the replay's writes: it is not served after this."""
    import torch

    from repro_torch import tree_map

    g = _graphs(eng)
    racy_sink = eng._kernel_decision() == "kernel"
    out = {}
    for S, packed in sorted(g.inputs_seen.items()):
        pool = tree_map(torch.clone, eng.pool)
        tok = eng._tok.clone()
        keys = eng._keys.clone()
        s_e, l_e = _eager_step(eng, pool, tok, keys, packed, S)
        n = g.replays
        s_g, l_g = g.run(S, packed, eng._upload)
        torch.cuda.synchronize()
        pools = []
        tree_map(pools.append, pool)
        mine = []
        tree_map(mine.append, eng.pool)
        pages = all(torch.equal(a[:, 1:], b[:, 1:])
                    if racy_sink and a.dim() == 5 and a.dtype != torch.int8
                    else torch.equal(a, b) for a, b in zip(mine, pools))
        out[str(S)] = {"sampled": torch.equal(s_g, s_e),
                       "logits": torch.equal(l_g, l_e),
                       "token": torch.equal(eng._tok, tok),
                       "keys": torch.equal(eng._keys, keys),
                       "pages_and_scales": pages,
                       "replayed": g.replays == n + 1}
        require(all(out[str(S)].values()),
                f"bucket {S}: the replay differs from the eager step: "
                f"{out[str(S)]}")
    return out


def _graphs_replayed(eng, what: str, compare: bool = True) -> dict:
    """Every step of a tp = 1 serve on the card replays a captured graph
    but each bucket's first; with ``compare``, each bucket's replay is the
    eager step (:func:`_replay_vs_eager`)."""
    stats = _graph_stats(eng)
    require(stats is not None and stats["replays"] > 0
            and stats["captures"] == len(stats["buckets"])
            and stats["captures"] + stats["replays"]
            == eng.stats["mixed_steps"],
            f"{what}: every step but a bucket's first must replay its "
            f"graph: {stats}")
    if compare:
        stats["replay_vs_eager"] = _replay_vs_eager(eng)
    return stats


def _cow_window(cfg, params, **engine_kw) -> dict:
    """Host syncs over a trace that forks pages copy-on-write, on a warmed
    engine: a shared 40-token prefix, prompts added one every 3 steps, the
    repeat of one and the extension of another matching a committed
    partial page.  Every dispatched step is harvested once, so the engine
    means exactly one sync a step, the fork's copy included."""
    import numpy as np
    import torch

    from repro_torch.serving import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(cfg, params, **{**SERVE_KW, **engine_kw})
    _warm(eng, cfg.vocab)
    rng = np.random.default_rng(11)
    prefix = list(rng.integers(0, cfg.vocab, 40))
    shared = [np.asarray(prefix + [(17 * i + j) % cfg.vocab
                                   for j in range(3 + i % 2)])
              for i in range(4)]
    prompts = shared + [shared[1], np.concatenate([shared[0], [5, 6]])]
    g = _graphs(eng)
    before = {k: eng.stats[k] for k in ("mixed_steps", "cow_forks")}
    cap0 = g.captures if g else 0
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _drive(eng, prompts, 3, 8, "copy-on-write window")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("called a synchronizing CUDA operation" in str(w.message)
                for w in caught)
    steps = eng.stats["mixed_steps"] - before["mixed_steps"]
    forks = eng.stats["cow_forks"] - before["cow_forks"]
    out = {"steps": steps, "cow_forks": forks, "host_syncs": syncs,
           "host_syncs_per_step": syncs / steps,
           "captures": (g.captures - cap0) if g else None}
    require(forks > 0, "the copy-on-write window forked no page")
    require(syncs == steps, f"copy-on-write window: {syncs} host syncs "
            f"over {steps} steps, not 1 a step")
    require(not g or g.captures == cap0,
            "the copy-on-write window captured a graph")
    return out


# -- phase 3e: fault-tolerant serving --------------------------------------

def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ft_trace(vocab: int, deadline: tuple = (), seed: int = 0,
              new_tokens: int = 32) -> list:
    """Phase 3's eight requests (prompts of 32 to 256 tokens from
    ``seed``), ``new_tokens`` each: odd requests sample at FT_TEMPERATURE
    from seed 1000 + i, even ones are greedy; the requests in
    ``deadline`` carry a 600 s deadline.  [(prompt, SamplingParams)]."""
    from repro_torch.serving import SamplingParams

    return [(p, SamplingParams(
        max_new_tokens=new_tokens,
        temperature=FT_TEMPERATURE if i % 2 else 0.0, seed=1000 + i,
        deadline_s=600.0 if i in deadline else None))
        for i, p in enumerate(_serve_prompts(vocab, 8, 32, 256, seed))]


def _ft_serve(eng, done: dict, what: str, check=None, trace=(),
              every: int = 0, steps: Optional[int] = None) -> list:
    """Add ``trace``'s requests, all at once (``every`` 0) or one every
    ``every`` steps (a family's leader commits its prefix before the next
    member arrives), and step ``eng`` to the end, or for ``steps`` steps:
    every finished request's (tokens, finish reason) into ``done`` by id
    (a request reported again must bring the same tokens), ``check(eng)``
    after every step.  Returns the requests added."""
    reqs, n, pending = [], 0, list(trace)
    while (pending or eng.has_work()) and (steps is None or n < steps):
        while pending and (every == 0 or n % every == 0):
            p, sp = pending.pop(0)
            reqs.append(eng.add_request(p, sp))
            if every:
                break
        for r in eng.step():
            tok = list(r.output_tokens)
            prev = done.get(r.req_id)
            require(prev is None or prev[0] == tok,
                    f"request {r.req_id} reported twice with other tokens")
            done[r.req_id] = (tok, r.finish_reason.value)
        if check is not None:
            check(eng)
        n += 1
        require(n < 3000, f"{what} did not finish")
    return reqs


def _per_step(counts: dict, steps: int) -> dict:
    return {k: v / steps for k, v in counts.items() if v}


def _nongeometry(kw: dict) -> dict:
    from repro_torch.serving.snapshot import GEOMETRY_KEYS

    return {k: v for k, v in kw.items() if k not in GEOMETRY_KEYS}


def _ft_uninterrupted(cfg, params, trace, dev, **kw) -> dict:
    """The trace served to the end by one engine, all requests at once:
    tokens by request, launches a step, graphs."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serving import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(cfg, params, **{**SERVE_KW, **kw})
    done: dict = {}
    _sync(dev)
    reset_launches()
    t0 = time.perf_counter()
    reqs = _ft_serve(eng, done, "the uninterrupted serve", trace=trace)
    _sync(dev)
    dt = time.perf_counter() - t0
    steps = eng.stats["mixed_steps"]
    return {"tokens": [done[r.req_id][0] for r in reqs],
            "reasons": [done[r.req_id][1] for r in reqs],
            "steps": steps, "seconds": dt,
            "per_step": _per_step(launches(), steps),
            "graphs": _graph_stats(eng)}


def _ft_restore(cfg, params, trace, base: dict, at: int, include_kv: bool,
                where: Path, dev, **kw) -> dict:
    """Serve ``trace`` for ``at`` steps, ``save_snapshot`` it under
    ``where`` (full, or host state only), drop the engine,
    ``restore_latest`` a new one and serve to the end: its tokens must be
    ``base``'s, and so must its launches a step."""
    import shutil

    import torch

    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serving import ContinuousBatchingEngine, RequestState

    eng = ContinuousBatchingEngine(cfg, params, **{**SERVE_KW, **kw})
    done: dict = {}
    reqs = _ft_serve(eng, done, "the serve to its snapshot", trace=trace,
                     steps=at)
    prefilling = sum(s.request.state is RequestState.PREFILLING
                     for s in eng.running.values())
    decoding = sum(s.request.state is RequestState.RUNNING
                   for s in eng.running.values())
    shutil.rmtree(where, ignore_errors=True)
    _sync(dev)
    t0 = time.perf_counter()
    snap = eng.save_snapshot(where, include_kv=include_kv)
    t_save = time.perf_counter() - t0
    step_dir = where / f"step_{snap['step_idx']:08d}"
    n_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
    del eng, snap
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    new = ContinuousBatchingEngine.restore_latest(
        where, cfg, params, **_nongeometry({**SERVE_KW, **kw}))
    _sync(dev)
    t_restore = time.perf_counter() - t0
    reset_launches()
    _ft_serve(new, done, "the restored serve")
    steps = new.stats["mixed_steps"]
    per_step = _per_step(launches(), steps)
    tokens = [done[r.req_id][0] for r in reqs]
    shutil.rmtree(where)
    out = {"at_step": at, "include_kv": include_kv,
           "prefilling_at_snapshot": prefilling,
           "decoding_at_snapshot": decoding,
           "snapshot_bytes": n_bytes, "save_seconds": t_save,
           "restore_seconds": t_restore, "steps_after_restore": steps,
           "restored_graphs": _graph_stats(new),
           "launches_per_step": per_step,
           "tokens_identical": tokens == base["tokens"],
           "launches_per_step_identical": per_step == base["per_step"]}
    require(out["tokens_identical"],
            f"restore at step {at} (include_kv={include_kv}): tokens differ "
            f"from the uninterrupted run: {tokens} vs {base['tokens']}")
    require(out["launches_per_step_identical"],
            f"restore at step {at}: launches a step {per_step} differ from "
            f"the uninterrupted engine's {base['per_step']}")
    return out


def _ft_faults(cfg, params, base: dict, dev, **kw) -> dict:
    """The seeded random fault schedule (no crashes) over the trace, the
    recovery invariants after every step: every request but the two whose
    deadline the clock skew expires serves ``base``'s tokens."""
    from repro_torch.ft.coordinator import EngineSupervisor
    from repro_torch.serving import (ContinuousBatchingEngine, FaultInjector,
                                     assert_recovery_invariants)

    fi = FaultInjector(seed=FT_FAULT_SEED).random_schedule(6, max_step=24)
    sup = EngineSupervisor(timeout_s=60.0)
    eng = ContinuousBatchingEngine(cfg, params, fault_injector=fi,
                                   **{**SERVE_KW, **kw})
    sup.attach(eng)
    done: dict = {}
    t0 = time.perf_counter()
    reqs = _ft_serve(eng, done, "the faulted serve",
                     assert_recovery_invariants,
                     trace=_ft_trace(cfg.vocab, deadline=(6, 7)))
    steps = eng.step_idx
    _sync(dev)
    dt = time.perf_counter() - t0
    fi.release_all(eng)
    assert_recovery_invariants(eng)
    fired = {k for _, k, _ in fi.log}
    kept = [i for i, r in enumerate(reqs)
            if done[r.req_id][1] in ("length", "eos")]
    out = {"schedule": sorted((e.step, e.kind) for e in fi.events),
           "log": [list(e) for e in fi.log], "steps": steps, "seconds": dt,
           "reasons": [done[r.req_id][1] for r in reqs],
           "stats": {k: eng.stats[k] for k in (
               "dispatch_failures", "preemptions", "timeouts",
               "mixed_steps")},
           "heartbeat_silenced": eng.heartbeat is None,
           "supervisor_sees_silence": sup.engine_failed(
               now=sup.heartbeat._last[sup.rank] + 61.0),
           "tokens_identical": all(
               done[reqs[i].req_id][0] == base["tokens"][i] for i in kept)}
    require(set(FT_FAULT_KINDS) <= fired,
            f"the fault schedule fired only {sorted(fired)}")
    require(out["reasons"][6:] == ["timeout", "timeout"]
            and len(kept) == 6,
            f"the clock skew must time out requests 6 and 7 alone: "
            f"{out['reasons']}")
    require(eng.stats["dispatch_failures"] == 1
            and eng.stats["preemptions"] > 0,
            f"the faulted serve recovered nothing: {out['stats']}")
    require(out["heartbeat_silenced"] and out["supervisor_sees_silence"],
            "heartbeat silence went unseen")
    require(out["tokens_identical"],
            "a request the faults did not abort lost its unfaulted tokens")
    return out


def _ft_crashes(cfg, params, base: dict, dev, **kw) -> dict:
    """Crashes before and after the harvest, each recovered by an
    EngineSupervisor from the snapshot it was last published (every 4
    steps): every request serves ``base``'s tokens."""
    from repro_torch.ft.coordinator import EngineSupervisor
    from repro_torch.serving import (ContinuousBatchingEngine, FaultInjector,
                                     SimulatedCrash,
                                     assert_recovery_invariants)

    fi = FaultInjector(seed=0).schedule(7, "crash_before_harvest") \
        .schedule(18, "crash_after_harvest")
    sup = EngineSupervisor(timeout_s=60.0)
    eng = ContinuousBatchingEngine(cfg, params, fault_injector=fi,
                                   **{**SERVE_KW, **kw})
    sup.attach(eng)
    reqs = [eng.add_request(p, sp) for p, sp in _ft_trace(cfg.vocab)]
    done: dict = {}
    recoveries, publish_s, steps = [], [], 0
    while eng.has_work():
        if eng.step_idx % 4 == 0:
            t0 = time.perf_counter()
            sup.publish(eng.snapshot())
            publish_s.append(time.perf_counter() - t0)
        try:
            _ft_serve(eng, done, "the crashing serve",
                      assert_recovery_invariants, steps=1)
        except SimulatedCrash as e:
            crashed_at = eng.step_idx
            t0 = time.perf_counter()
            eng = sup.recover(cfg, params, fault_injector=fi,
                              **_nongeometry({**SERVE_KW, **kw}))
            _sync(dev)
            recoveries.append({"kind": e.kind, "crashed_at_step": crashed_at,
                               "restored_step": eng.step_idx,
                               "seconds": time.perf_counter() - t0})
        steps += 1
        require(steps < 2000, "the crashing serve did not finish")
    tokens = [done[r.req_id][0] for r in reqs]
    out = {"log": [list(e) for e in fi.log], "recoveries": recoveries,
           "publishes": len(publish_s), "publish_seconds": publish_s,
           "tokens_identical": tokens == base["tokens"]}
    require([r["kind"] for r in recoveries]
            == ["crash_before_harvest", "crash_after_harvest"],
            f"the crashes did not both fire: {recoveries}")
    require(out["tokens_identical"],
            "the crash-recovered serve's tokens differ from the "
            "uninterrupted run")
    return out


def _ft_family_trace(vocab: int, seed: int, n: int = 8,
                     new_tokens: int = 16,
                     tails_seed: Optional[int] = None) -> list:
    """``n`` requests over 4 shared-prefix families (a 48-token stem and a
    16- to 64-token tail each; the stems from ``seed``, the tails from
    ``tails_seed`` where given), odd ones sampled at FT_TEMPERATURE."""
    import numpy as np

    from repro_torch.serving import SamplingParams

    rng = np.random.default_rng(seed)
    stems = [list(rng.integers(0, vocab, 48)) for _ in range(4)]
    if tails_seed is not None:
        rng = np.random.default_rng(tails_seed)
    return [(np.asarray(stems[i % 4] + list(rng.integers(
        0, vocab, int(rng.integers(16, 65))))), SamplingParams(
        max_new_tokens=new_tokens,
        temperature=FT_TEMPERATURE if i % 2 else 0.0, seed=2000 + i))
        for i in range(n)]


def _arm_crash(rep, kind: str = "crash_before_harvest"):
    """A SimulatedCrash on one replica at its next step."""
    from repro_torch.serving import FaultInjector

    rep.faults = FaultInjector(seed=0).schedule(rep.step_idx + 1, kind)


def _ft_replicas(cfg, params, dev, **kw) -> dict:
    """Two replicas behind the affinity router on the one card: tokens of
    a single engine, affinity hits; replica 1 killed once with a published
    snapshot (failover in place) and once without (migration), its fleet's
    v2 snapshot restored while it is DOWN; a poison request quarantined
    after two kills; scale_to(3) then scale_to(1); the fleet invariants
    after every step.  Readings: tokens/s of 1 and 2 replicas at a load
    that fills every slot, and the card's peak memory of each."""
    import torch

    from repro_torch.serving import (ContinuousBatchingEngine, ReplicaHealth,
                                     ReplicatedEngine,
                                     assert_fleet_invariants)

    ekw = {**SERVE_KW, **kw}
    check = assert_fleet_invariants
    trace = _ft_family_trace(cfg.vocab, seed=5)
    single = ContinuousBatchingEngine(cfg, params, **ekw)
    done: dict = {}
    reqs = _ft_serve(single, done, "the single engine", trace=trace,
                     every=2)
    base = [done[r.req_id][0] for r in reqs]
    del single
    out: dict = {}

    def tokens_of(reqs, done):
        return [done[r.req_id][0] for r in reqs]

    # affinity: the same tokens, families routed together
    fleet = ReplicatedEngine(cfg, params, n_replicas=2, routing="affinity",
                             **ekw)
    done = {}
    reqs = _ft_serve(fleet, done, "the affinity fleet", check, trace=trace,
                     every=2)
    router = fleet.stats()["router"]
    out["affinity"] = {
        "tokens_identical": tokens_of(reqs, done) == base,
        "owners": [fleet.stats()["replicas"][i]["finished"]
                   for i in range(2)],
        "router": router}
    require(out["affinity"]["tokens_identical"],
            "two replicas' tokens differ from a single engine's")
    require(router["router.affinity_hits"] > 0,
            f"the affinity router hit no prefix: {router}")
    del fleet

    # replica 1 killed mid-trace: with a published snapshot, and without
    for mode in ("snapshot", "migration"):
        fleet = ReplicatedEngine(cfg, params, n_replicas=2,
                                 routing="affinity", **ekw)
        done = {}
        reqs = _ft_serve(fleet, done, f"the {mode} fleet", check,
                         trace=trace, every=2, steps=2 * len(trace))
        if mode == "snapshot":
            t0 = time.perf_counter()
            fleet.publish_snapshots()
            publish_s = time.perf_counter() - t0
        _ft_serve(fleet, done, f"the {mode} fleet", check, steps=2)
        require(fleet.replicas[1].has_work(),
                f"{mode}: replica 1 has no work to lose")
        _arm_crash(fleet.replicas[1])
        t0 = time.perf_counter()
        _ft_serve(fleet, done, f"the {mode} fleet", check, steps=1)
        _sync(dev)
        fail_s = time.perf_counter() - t0
        r = fleet.stats()["router"]
        line = {"failover_step_seconds": fail_s,
                "health": fleet.stats()["health"],
                "down_cause": fleet.down_cause(1), "router": dict(r)}
        if mode == "snapshot":
            line["publish_seconds"] = publish_s
            require(fleet.health(1) is ReplicaHealth.HEALTHY
                    and r["router.restored_replicas"] == 1,
                    f"replica 1 was not restored in place: {line}")
        else:
            require(fleet.health(1) is ReplicaHealth.DOWN
                    and r["router.migrations"] > 0,
                    f"replica 1's requests did not migrate: {line}")
            # the degraded fleet's v2 snapshot round trip
            _ft_serve(fleet, done, "the degraded fleet", check, steps=1)
            t0 = time.perf_counter()
            snap = fleet.snapshot()
            back = ReplicatedEngine.restore(snap, cfg, params,
                                            **_nongeometry(ekw))
            line["v2_round_trip_seconds"] = time.perf_counter() - t0
            require(snap["format"] == "replicated-engine-snapshot-v2"
                    and back.health(1) is ReplicaHealth.DOWN
                    and back._owner == fleet._owner,
                    "the degraded fleet's snapshot did not round-trip")
            del fleet
            fleet = back
        _ft_serve(fleet, done, f"the {mode} fleet", check)
        line["tokens_identical"] = tokens_of(reqs, done) == base
        require(line["tokens_identical"],
                f"{mode} failover: tokens differ from a single engine's")
        out[f"kill_{mode}"] = line
        if mode == "migration":
            # elasticity on the survivor fleet: revive and grow, shrink
            grow = fleet.scale_to(3)
            more = _ft_family_trace(cfg.vocab, seed=6, n=6, new_tokens=8)
            rs = _ft_serve(fleet, done, "the grown fleet", check,
                           trace=more, steps=2)
            owners = {fleet.owner_of(q.req_id) for q in rs}
            shrink = fleet.scale_to(1)
            _ft_serve(fleet, done, "the rescaled fleet", check)
            out["scale"] = {
                "grow": dataclasses.asdict(grow),
                "shrink": dataclasses.asdict(shrink),
                "owners_after_grow": sorted(owners),
                "health": fleet.stats()["health"],
                "reasons": [done[q.req_id][1] for q in rs]}
            require(grow.action == "grow" and fleet.n_replicas == 3
                    and shrink.action == "shrink"
                    and fleet.stats()["health"].count("healthy") == 1
                    and all(done[q.req_id][1] == "length" for q in rs),
                    f"scale_to(3) then scale_to(1) failed: {out['scale']}")
        del fleet

    # a poison request: its replica dies twice under it
    fleet = ReplicatedEngine(cfg, params, n_replicas=3,
                             routing="round_robin", max_request_retries=2,
                             **ekw)
    small = _ft_family_trace(cfg.vocab, seed=7, n=3, new_tokens=8)
    rs = [fleet.add_request(p, sp) for p, sp in small]
    done = {}
    first = fleet.owner_of(rs[0].req_id)
    _arm_crash(fleet.replicas[first])
    _ft_serve(fleet, done, "the poison fleet", check, steps=1)
    second = fleet.owner_of(rs[0].req_id)
    require(second is not None and second != first,
            "the poison request did not migrate after the first kill")
    _arm_crash(fleet.replicas[second])
    _ft_serve(fleet, done, "the poison fleet", check)
    out["quarantine"] = {"quarantined": sorted(fleet.quarantined),
                         "reasons": [done[q.req_id][1] for q in rs],
                         "router": fleet.stats()["router"]}
    require(rs[0].req_id in fleet.quarantined
            and done[rs[0].req_id][1] == "aborted"
            and all(done[q.req_id][1] == "length" for q in rs[1:])
            and fleet.stats()["router"]["router.quarantined"] == 1,
            f"the poison request was not quarantined: {out['quarantine']}")
    del fleet

    # readings: 1 and 2 replicas on one card at a load that fills every
    # slot (FT_LOAD_REQUESTS requests over the 4 families, all at once,
    # FT_LOAD_NEW_TOKENS each).  Each fleet is warmed on one such load (its
    # graphs captured, each family's stem committed on the replica the
    # router then sends the family to), then timed on two more, in the
    # order 1, 2, 2, 1; both fleets serve each load to the same tokens
    fleets, readings, tokens = {}, {}, {}
    for n in (1, 2):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        fleets[n] = ReplicatedEngine(cfg, params, n_replicas=n,
                                     routing="affinity", **ekw)
        _ft_serve(fleets[n], {}, f"{n} replicas' warm-up", trace=(
            _ft_family_trace(cfg.vocab, seed=10, n=FT_LOAD_REQUESTS,
                             new_tokens=FT_LOAD_NEW_TOKENS, tails_seed=0)))
        peak = torch.cuda.max_memory_allocated(dev)
        readings[str(n)] = {"allocated_before": before,
                            "max_memory_allocated": peak,
                            "fleet_peak_bytes": peak - before, "runs": []}
    for i, n in enumerate((1, 2, 2, 1)):
        load = _ft_family_trace(cfg.vocab, seed=10, n=FT_LOAD_REQUESTS,
                                new_tokens=FT_LOAD_NEW_TOKENS,
                                tails_seed=1 + i // 2)
        fleet, done = fleets[n], {}
        hits = fleet.stats()["router"]["router.affinity_hits"]
        steps = [r.step_idx for r in fleet.replicas]
        fin = [r.stats["finished"] for r in fleet.replicas]
        _sync(dev)
        t0 = time.perf_counter()
        rs = _ft_serve(fleet, done, f"{n} replicas' load", trace=load)
        _sync(dev)
        dt = time.perf_counter() - t0
        toks = [done[q.req_id][0] for q in rs]
        tokens.setdefault(i // 2, {})[n] = toks
        n_out = sum(map(len, toks))
        readings[str(n)]["runs"].append({
            "load": 1 + i // 2, "requests": len(rs), "tokens": n_out,
            "seconds": dt, "tokens_per_s": n_out / dt,
            "replica_steps": [r.step_idx - s0
                              for r, s0 in zip(fleet.replicas, steps)],
            "replica_requests": [r.stats["finished"] - f0
                                 for r, f0 in zip(fleet.replicas, fin)],
            "affinity_hits": fleet.stats()["router"][
                "router.affinity_hits"] - hits})
    del fleets
    out["readings"] = readings
    require(all(t[1] == t[2] for t in tokens.values()),
            "1 and 2 replicas served a load to other tokens")
    require(all(min(run["replica_requests"]) >= ekw["max_slots"]
                for run in readings["2"]["runs"]),
            f"a replica was not given enough of a load to fill its slots: "
            f"{readings['2']['runs']}")
    return out


def _tp_rank(mesh, jobs: dict) -> dict:
    """One rank of phase 5: for each job, the full params from their seed
    on this rank's device (then sliced by the engine), every trace served
    to the end through the tensor-parallel engine, with its tokens,
    counters, launches and wall time; optionally every step's logits and
    a profiled window.  Also run with ``mesh=None`` for tp = 1 baselines."""
    import torch

    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import transformer as T
    from repro_torch.serving import ContinuousBatchingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda") if mesh is None else mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    out = {}
    for job, spec in jobs.items():
        cfg = spec["cfg"]
        params = T.init_params(cfg, seed=spec["seed"], device=dev)
        res = out[job] = {"checksum": _checksum(params), "traces": {}}
        for name, (kw, prompts, stagger, max_new) in spec["traces"].items():
            logits: list = []
            eng = ContinuousBatchingEngine(cfg, params, mesh=mesh,
                                           **({} if mesh else
                                              {"device": dev}), **kw)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            reqs = _drive(eng, prompts, stagger, max_new, f"{job} {name}",
                          logits if spec.get("record") else None)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            eng.pool_host.check_invariants()
            eng.kv.check_shards()
            n_out = sum(len(r.output_tokens) for r in reqs)
            res["traces"][name] = {
                "tokens": [list(r.output_tokens) for r in reqs],
                "stats": {k: eng.stats[k] for k in (
                    "mixed_steps", "preemptions", "prefix_hit_tokens",
                    "cow_forks", "kernel_dispatches", "dense_fallbacks")},
                "launches": launches(), "seconds": dt,
                "tokens_per_s": n_out / dt,
                "pages_per_shard": eng.pool_host.n_pages - 1,
                "local_page_shape": list(
                    eng.pool["layers"]["attn"]["k_pages"].shape),
                "logits": logits if mesh is None or mesh.rank == 0 else []}
            del eng
        if spec.get("profile"):
            res["profile"] = _profile_serve(cfg, params, mesh=mesh)
        if spec.get("snapshot"):
            res["snapshot"] = _tp_snapshot(mesh, cfg, params,
                                           spec["snapshot"])
        del params
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return out


def _phase_ft(dev) -> None:
    """Phase 3e: fault-tolerant serving of gpt2-medium at full width (bf16,
    seed 0, phase 3's geometry, pool and trace; odd requests sampled at
    FT_TEMPERATURE): snapshot/restore through the checkpoint store (full
    and host state only, with prefill in flight and decoding; float, then
    int8 factors with int8 KV), the seeded faults, crash recovery by the
    EngineSupervisor, and two replicas behind the router."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    gpt2 = get_config("gpt2-medium")
    qopts = dict(quantize="int8", fuse_projections=True, kv_dtype="int8")
    ft_cfg = dataclasses.replace(gpt2, monarch=dataclasses.replace(
        gpt2.monarch, backend="pallas"))
    ft_params = T.init_params(ft_cfg, seed=0, device=dev)
    ft_trace = _ft_trace(ft_cfg.vocab)
    for opts, points, need in (
            ({}, ((2, True), (2, False), (12, True), (12, False)),
             ("monarch_fused", "paged_attention_span", "sample_tokens")),
            (qopts, ((2, True), (12, True)),
             ("monarch_fused_q", "paged_attention_span_q",
              "quantize_kv_write", "sample_tokens"))):
        base = _ft_uninterrupted(ft_cfg, ft_params, ft_trace, dev, **opts)
        g = base["graphs"]
        emit({"phase": "ft_uninterrupted", "options": opts,
              **{k: base[k] for k in ("steps", "seconds", "per_step",
                                      "graphs", "reasons")}})
        require(all(base["per_step"].get(k, 0) > 0 for k in need),
                f"3e {opts}: the serve did not run {need}: "
                f"{base['per_step']}")
        require(g["replays"] > 0
                and g["captures"] + g["replays"] == base["steps"],
                f"3e {opts}: every step but a bucket's first must replay "
                f"its graph: {g}")
        if not opts:
            ft_base = base
        for at, kv in points:
            line = _ft_restore(ft_cfg, ft_params, ft_trace, base, at, kv,
                               FT_DIR / "engine", dev, **opts)
            emit({"phase": "ft_restore", "options": opts, **line})
            require(line["prefilling_at_snapshot"] > 0 if at == 2 else
                    line["prefilling_at_snapshot"] == 0
                    and line["decoding_at_snapshot"] > 0,
                    f"3e: the snapshot at step {at} is not where it must "
                    f"be (prefill in flight at 2, decoding at 12): {line}")
    emit({"phase": "ft_faults",
          **_ft_faults(ft_cfg, ft_params, ft_base, dev)})
    emit({"phase": "ft_crashes",
          **_ft_crashes(ft_cfg, ft_params, ft_base, dev)})
    emit({"phase": "ft_replicas", **_ft_replicas(ft_cfg, ft_params, dev)})
    del ft_params
    torch.cuda.empty_cache()


# -- phase 3f: the ring cache and the legacy ServeEngine ---------------------

def _ring_window(dev, step, n: int) -> dict:
    """``n`` calls of ``step`` (one decode step each): wall ms a step of
    the synchronized loop, and torch.profiler's device ms a step, the
    device ms of PyTorch's own kernels (outside the PROFILED families),
    the launch families' kernels a step (PROFILED) and the top kernels
    (ms and launches a step; one profile a step)."""
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    _sync(dev)
    wall = (time.perf_counter() - t0) / n
    by_key = _profile_steps(step, n, lambda: _sync(dev))
    device = sum(us for us, _ in by_key.values()) / 1e3 / n
    seen = {name: sum(k for key, (_, k) in by_key.items() if name in key) / n
            for name in PROFILED}
    top = sorted(((us / 1e3 / n, key, k / n)
                  for key, (us, k) in by_key.items()), reverse=True)[:8]
    own = sum(us for key, (us, _) in by_key.items()
              if not any(name in key for name in PROFILED)) / 1e3 / n
    return {"wall_ms_per_step": wall * 1e3, "device_ms_per_step": device,
            "device_busy_share": device / (wall * 1e3),
            "pytorch_kernels_ms_per_step": own,
            "kernels_per_step_profiled": seen,
            "launches_per_step_profiled": sum(k for _, k in by_key.values())
            / n,
            "top_kernels_ms_per_step": [[key[:70], ms, k]
                                        for ms, key, k in top]}


def _ring_logits(eng, prompts, n: int) -> tuple[list, list]:
    """A greedy ``generate`` by hand on the engine's own ring: each step's
    tokens and logits (the prefill's, then each decode step's), on the
    host."""
    import torch

    from repro_torch.kernels.sample import sample_block

    cache = eng._ring(prompts.shape[0])
    key = torch.zeros((1, 2), dtype=torch.int32, device=eng.device)
    temps = torch.zeros(prompts.shape[0], device=eng.device)
    logits, cache = eng._prefill(eng.params, prompts, cache)
    toks, lgs = [], []
    for i in range(n):
        if i:
            logits, cache = eng._decode(eng.params, tok, cache)
        tok = sample_block(logits, temps, key, False)
        toks.append(tok.cpu())
        lgs.append(logits.float().cpu())
    return toks, lgs


def _ring_vs_paged(eng, cb_tokens: list, prompts) -> dict:
    """Greedy tokens of the ring engine (``ServeEngine``) against the
    continuous-batching engine's on the same prompts: identical, or the
    first (row, token) where they part, with the ring's logit margin
    there (its best against its second best, and against the paged
    engine's token)."""
    toks, lgs = _ring_logits(eng, prompts, len(cb_tokens[0]))
    ring = [[int(t[b]) for t in toks] for b in range(prompts.shape[0])]
    first = min(((j, b) for b in range(len(ring))
                 for j, (x, y) in enumerate(zip(ring[b], cb_tokens[b]))
                 if x != y), default=None)
    out = {"identical": ring == cb_tokens,
           "rows_identical": sum(a == b for a, b in zip(ring, cb_tokens)),
           "rows": len(ring)}
    if first is not None:
        j, b = first
        lg = lgs[j][b]
        top = lg.topk(2)
        out["first_parting"] = {
            "row": b, "token": j, "ring": ring[b][j], "paged": cb_tokens[b][j],
            "ring_top2_margin": float(top.values[0] - top.values[1]),
            "ring_margin_over_paged_token": float(
                lg[ring[b][j]] - lg[cb_tokens[b][j]])}
    return out


def _phase_ring(dev) -> dict:
    """Phase 3f: gpt2-medium at full width (24 layers, bf16, seed 0
    weights) through the legacy ``ServeEngine``: greedy and sampled
    generates at B = RING_BATCH, prompt RING_PROMPT, RING_NEW new tokens,
    every decode step a replay of the ring's CUDA graph; the replay
    ``torch.equal`` to an eager ``decode_step`` on a cloned ring, and
    ``decode_step_layerwise`` ``torch.equal`` to ``decode_step``; the
    launches a decode step (counters and profiler), the host syncs a
    ``generate``; the prefill, the graph's and the layerwise loop's decode
    step (wall and device ms) and tokens/s; the ``_prefill = None``
    baseline at B = 1; greedy tokens against the continuous-batching
    engine's on the same prompts (bf16: a reading).  Returns the
    launches of the timed greedy generate."""
    import torch

    from repro_torch import tree_map
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.kernels.sample import sample_block
    from repro_torch.models import transformer as T
    from repro_torch.models.decode_path import decode_step_layerwise
    from repro_torch.serving import (ContinuousBatchingEngine,
                                     GenerationConfig, SamplingParams,
                                     ServeEngine)

    gpt2 = get_config("gpt2-medium")
    cfg = dataclasses.replace(gpt2, monarch=dataclasses.replace(
        gpt2.monarch, backend="pallas"))
    params = T.init_params(cfg, seed=0, device=dev)
    eng = ServeEngine(cfg, params, device=dev)
    B, S, n = RING_BATCH, RING_PROMPT, RING_NEW
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=gen)
    greedy = GenerationConfig(max_new_tokens=n)
    runs = {"greedy": greedy,
            "sampled": GenerationConfig(max_new_tokens=n,
                                        temperature=SAMPLE_TEMPERATURE,
                                        seed=0)}
    eng.generate(prompts, greedy)          # captures the ring's graph
    g = eng._decode.graphs
    require(g.captures == 1 and g.buckets == [(B, eng.max_len)],
            f"3f: one decode graph for the ring: {g.buckets}")
    per_step = {"monarch_fused": 6 * cfg.n_layers, "sample_tokens": 1}
    out: dict = {"model": "gpt2-medium", "dtype": cfg.dtype,
                 "layers": cfg.n_layers, "B": B, "prompt": S,
                 "new_tokens": n, "max_len": eng.max_len}
    for name, gc in runs.items():
        _sync(dev)
        reset_launches()
        replays = g.replays
        t0 = time.perf_counter()
        toks = eng.generate(prompts, gc)
        dt = time.perf_counter() - t0
        counts = {k: v for k, v in launches().items() if v}
        out[name] = {"seconds": dt, "tokens_per_s": B * n / dt,
                     "launches": counts, "replays": g.replays - replays,
                     "tokens": toks[:2].tolist()}
        require(tuple(toks.shape) == (B, n) and int(toks.min()) >= 0
                and int(toks.max()) < cfg.vocab,
                f"3f {name}: tokens {tuple(toks.shape)} out of the vocab")
        require(counts == {k: v * n for k, v in per_step.items()}
                and g.replays - replays == n - 1,
                f"3f {name}: launches {counts}, replays "
                f"{g.replays - replays} (want {per_step} a step, {n - 1} "
                f"replays)")
        if name == "greedy":
            greedy_toks, greedy_counts = toks, counts
    # host syncs of a warmed generate: the one fetch of the tokens
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.generate(prompts, runs["sampled"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    out["host_syncs_per_generate"] = sum(
        "called a synchronizing CUDA operation" in str(w.message)
        for w in caught)
    require(out["host_syncs_per_generate"] == 1,
            f"3f: {out['host_syncs_per_generate']} host syncs a generate")
    # the replay against an eager decode_step, and the layerwise step
    # against decode_step, each on clones of the ring after a generate
    ring = eng._rings[B]
    tok = greedy_toks[:, -1].to(dev)
    c_eager, c1, c2 = (tree_map(torch.clone, ring) for _ in range(3))
    lg_graph, _ = eng._decode(eng.params, tok, ring)
    lg_eager, _ = T.decode_step(eng.params, tok, c_eager, cfg)
    lg_step, _ = T.decode_step(eng.params, tok, c1, cfg)
    lg_layer, _ = decode_step_layerwise(eng.params, tok, c2, cfg)
    _sync(dev)

    def same_rings(a, b) -> bool:
        la, lb = [], []
        tree_map(la.append, a)
        tree_map(lb.append, b)
        return all(torch.equal(x, y) for x, y in zip(la, lb))

    out["replay_vs_eager"] = {"logits": torch.equal(lg_graph, lg_eager),
                              "ring": same_rings(ring, c_eager)}
    out["layerwise_vs_step"] = {"logits": torch.equal(lg_layer, lg_step),
                                "ring": same_rings(c1, c2)}
    require(all(out["replay_vs_eager"].values())
            and all(out["layerwise_vs_step"].values()),
            f"3f: replay vs eager {out['replay_vs_eager']}, layerwise vs "
            f"step {out['layerwise_vs_step']}")
    # readings: the prefill, a decode step as the graph's replay and as
    # the layerwise loop (from the prefilled ring), launches a step
    prompts_dev = prompts.to(dev, torch.int32)
    pre = []
    for _ in range(3):
        cache = eng._ring(B)
        _sync(dev)
        t0 = time.perf_counter()
        eng._prefill(eng.params, prompts_dev, cache)
        _sync(dev)
        pre.append((time.perf_counter() - t0) * 1e3)
    out["prefill_ms"] = sorted(pre)[1]
    eng._prefill(eng.params, prompts_dev, eng._ring(B))
    reset_launches()
    lg, _ = eng._decode(eng.params, tok, ring)
    sample_block(lg, torch.zeros(B, device=dev),
                 torch.zeros((1, 2), dtype=torch.int32, device=dev), False)
    out["launches_per_decode_step"] = {k: v for k, v in launches().items()
                                       if v}
    require(out["launches_per_decode_step"] == per_step,
            f"3f: a decode step launched {out['launches_per_decode_step']}")

    def graph_step():
        eng._decode(eng.params, tok, ring)

    def layerwise_step():
        decode_step_layerwise(eng.params, tok, ring, cfg)

    out["decode_graph"] = _ring_window(dev, graph_step, 8)
    out["decode_layerwise"] = _ring_window(dev, layerwise_step, 8)
    for wname in ("decode_graph", "decode_layerwise"):
        seen = out[wname]["kernels_per_step_profiled"]
        require(seen["monarch_fused_kernel"] >= PROFILED_SHARE
                * per_step["monarch_fused"],
                f"3f {wname}: the profiler shows {seen} a step")
    # the prompt token by token through the decode graph, B = 1
    base = ServeEngine(cfg, params, device=dev)
    base._prefill = None
    base.generate(prompts[:1], greedy)     # captures the B = 1 graph
    _sync(dev)
    reset_launches()
    t0 = time.perf_counter()
    toks1 = base.generate(prompts[:1], greedy)
    dt = time.perf_counter() - t0
    counts = {k: v for k, v in launches().items() if v}
    out["no_prefill_B1"] = {
        "seconds": dt, "tokens_per_s": n / dt,
        "steps": S + n - 1, "ms_per_step": dt * 1e3 / (S + n - 1),
        "launches": counts,
        "tokens_equal_prefill_run": torch.equal(
            toks1, eng.generate(prompts[:1], greedy))}
    require(counts == {"monarch_fused": 6 * cfg.n_layers * (S + n - 1),
                       "sample_tokens": n},
            f"3f: the _prefill = None baseline ran {counts}")
    del base
    # the continuous-batching engine on the same prompts
    cb = ContinuousBatchingEngine(cfg, params, **SERVE_KW)
    reqs = [cb.add_request(p.numpy(), SamplingParams(max_new_tokens=n))
            for p in prompts]
    cb.run()
    out["vs_continuous_batching"] = _ring_vs_paged(
        eng, [list(r.output_tokens) for r in reqs], prompts_dev)
    del cb
    emit({"phase": "ring", **out})
    return greedy_counts


def _ring_nemotron(cfg, params, dev) -> dict:
    """Phase 3c's ServeEngine: one greedy generate of nemotron-4-15b
    (B = 8, prompt 64, 16 new tokens) on the serves' params, after a
    warm-up that captures its decode graph: B1 and B2 (staged w1 and
    w2), X3; the first GQA ring on the card."""
    import torch

    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serving import GenerationConfig, ServeEngine

    eng = ServeEngine(cfg, params, max_len=128, device=dev)
    prompts = torch.randint(0, cfg.vocab, (8, 64),
                            generator=torch.Generator().manual_seed(1))
    gc = GenerationConfig(max_new_tokens=16)
    eng.generate(prompts, gc)
    _sync(dev)
    reset_launches()
    t0 = time.perf_counter()
    toks = eng.generate(prompts, gc)
    dt = time.perf_counter() - t0
    counts = {k: v for k, v in launches().items() if v}
    g = eng._decode.graphs
    line = {"phase": "ring_nemotron", "B": 8, "prompt": 64, "new_tokens": 16,
            "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.hd],
            "seconds": dt, "tokens_per_s": 8 * 16 / dt, "launches": counts,
            "graphs": {"captures": g.captures, "replays": g.replays},
            "tokens": toks[:2].tolist()}
    emit(line)
    require(tuple(toks.shape) == (8, 16) and int(toks.max()) < cfg.vocab
            and counts.get("monarch_fused", 0) > 0
            and counts.get("bdmm", 0) > 0
            and counts.get("sample_tokens") == 16,
            f"3c: the nemotron ServeEngine must run B1, B2 and X3: {line}")
    return counts


def _example_runs(dev, variants=([], ["--engine", "legacy"])) -> list:
    """``python -m repro_torch.examples.serve_decode`` in-process on the
    card (runpy), once with each argument list of ``variants`` (3f: the
    default engine, then ``--engine legacy``; 3h: ``--arch mamba2-2_7b``);
    each must end "serve OK" with B1's launches counted in its report."""
    import contextlib
    import io
    import runpy

    from repro_torch.kernels import launches, reset_launches

    out = []
    for extra in variants:
        buf = io.StringIO()
        argv = sys.argv
        sys.argv = ["serve_decode", *extra]
        reset_launches()
        try:
            with contextlib.redirect_stdout(buf):
                runpy.run_module("repro_torch.examples.serve_decode",
                                 run_name="__main__", alter_sys=True)
            code = 0
        except SystemExit as e:
            code = e.code
        finally:
            sys.argv = argv
        lines = buf.getvalue().strip().splitlines()
        counts = {k: v for k, v in launches().items() if v}
        line = {"phase": "example_serve_decode", "argv": extra, "exit": code,
                "last": lines[-3:], "launches": counts}
        emit(line)
        require(code == 0 and lines[-1] == "serve OK"
                and lines[-2].startswith("kernel launches:")
                and counts.get("monarch_fused", 0) > 0,
                f"serve_decode {extra} did not end its report through B1: "
                f"{line}")
        out.append(line)
    return out


# -- phase 3g: mixture of experts and sandwich norms -------------------------

def _moe_rows(mc, tokens: int) -> int:
    """Rows each expert computes in a step of ``tokens`` tokens: the
    routing groups times the capacity (models/layers.py:moe_apply)."""
    sg = min(mc.group_size, tokens)
    while tokens % sg:
        sg //= 2
    cap = max(4, int(mc.capacity_factor * sg * mc.top_k / mc.n_experts))
    return tokens // sg * cap


@contextlib.contextmanager
def _recording_routes(into: list):
    """Every ``moe_apply`` call's route on the host, in call order: the
    router's probabilities (G, s, E), its top-k slots and the kept (token,
    expert) pairs after capacity (G, s, E), from ``layers._route`` and
    ``layers._dispatch`` (wrapped for the block; eager steps only)."""
    from repro_torch.models import layers as L

    route, dispatch = L._route, L._dispatch

    def rec_route(logits, mc):
        out = route(logits, mc)
        into.append({"probs": out[0].detach().float().cpu(),
                     "idx": out[2].cpu(), "k": mc.top_k})
        return out

    def rec_dispatch(idx, gates, E, cap, dtype):
        d, c = dispatch(idx, gates, E, cap, dtype)
        into[-1]["kept"] = (d.float().sum(-1) > 0).cpu()
        return d, c

    L._route, L._dispatch = rec_route, rec_dispatch
    try:
        yield into
    finally:
        L._route, L._dispatch = route, dispatch


def _route_check(card: list, cpu: list, what: str) -> dict:
    """The card's routes against the CPU's, call by call.  A token's route
    differs where its kept experts differ.  Until the first difference
    the two sides' router probabilities must agree within
    PARITY_REL_TOL; a difference must be a near tie within the call's
    margin, twice the largest probability difference card vs CPU.  A
    token whose top-k set differs is held to the CPU's k-th and (k+1)-th
    probabilities.  A token with the same top-k set lost or won a
    capacity slot through another token of its routing group, so it is
    held to the smallest gap there: the k-th to (k+1)-th gap of a token
    whose set differs, the closest two adjacent top-k probabilities of a
    token whose order differs.  After the first difference every later
    call is downstream of it and only reported.  Returns the report;
    fails on a difference that is not a near tie."""
    import torch

    require(len(card) == len(cpu), f"{what}: {len(card)} MoE calls on the "
            f"card, {len(cpu)} on the CPU")
    out = {"calls": len(card), "max_prob_diff": 0.0, "differences": [],
           "first_difference": None}
    for i, (a, b) in enumerate(zip(card, cpu)):
        dp = float((a["probs"] - b["probs"]).abs().max())
        margin = 2 * dp
        differs = (a["kept"] != b["kept"]).any(-1)               # (G, s)
        upstream = out["first_difference"] is not None
        if not upstream:
            out["max_prob_diff"] = max(out["max_prob_diff"], dp)
            require(dp <= PARITY_REL_TOL, f"{what}: MoE call {i}: router "
                    f"probabilities {dp} apart card vs CPU")
        if not bool(differs.any()):
            continue
        k = a["k"]
        srt = torch.sort(b["probs"], dim=-1, descending=True).values
        gap_k = srt[..., k - 1] - srt[..., k]                     # (G, s)
        adj = (srt[..., :k - 1] - srt[..., 1:k]).amin(-1) if k > 1 \
            else torch.full_like(gap_k, math.inf)
        own = (a["idx"].sort(-1).values != b["idx"].sort(-1).values).any(-1)
        order = (a["idx"] != b["idx"]).any(-1)
        # each token's own tie: its set's, else its order's, else none
        tie = torch.where(own, gap_k, torch.where(
            order, adj, torch.full_like(gap_k, math.inf)))       # (G, s)
        for g, t in differs.nonzero().tolist():
            if bool(own[g, t]):
                gap, kind = float(gap_k[g, t]), "top_k"
            else:      # the same k experts, a capacity slot went elsewhere
                gap, kind = float(tie[g].min()), "capacity"
            near = gap <= margin
            out["differences"].append({
                "call": i, "group": g, "token": t, "kind": kind,
                "gap": gap, "margin": margin, "near_tie": near,
                "downstream": upstream})
            require(near or upstream, f"{what}: MoE call {i} token {t}: "
                    f"the route differs card vs CPU without a near tie "
                    f"(gap {gap}, margin {margin})")
        if out["first_difference"] is None:
            out["first_difference"] = i
    return out


def _moe_step(params, cfg, d, toks, spans, table):
    """One mixed step of phase 4's geometry on device ``d``: the real
    vocab's fp32 logits on the CPU."""
    import torch

    from repro_torch.models import transformer as T

    B = toks.shape[0]
    pool = T.init_paged_pool(cfg, 1 + table.size, 16, device=d)
    lg, _ = T.paged_mixed_step(
        params, torch.from_numpy(toks).to(d),
        torch.zeros(B, dtype=torch.int32, device=d),
        torch.from_numpy(spans).to(d), torch.from_numpy(table).to(d), pool,
        cfg)
    return lg[:, :cfg.vocab].float().cpu()


def _moe_parity(cfg, dev, seed: int = 3) -> dict:
    """``cfg`` (the kernels on) at full width, cut to 2 layers, fp32,
    seeded random
    weights made on the card and copied to the CPU: one mixed step (phase
    4's geometry) card vs CPU, its MoE routes compared first, its logits
    within PARITY_REL_TOL; then a greedy trace of 4 requests (16 to 64
    prompt tokens, 8 new) through the engine on both (the card's steps
    eager, so that its routes are recorded too): identical tokens unless a
    route parted at a near tie, which is then printed."""
    import numpy as np
    import torch

    from repro_torch import tree_to
    from repro_torch.models import transformer as T
    from repro_torch.serving import ContinuousBatchingEngine

    c = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    p_gpu = T.init_params(c, seed=seed, device=dev)
    p_cpu = tree_to(p_gpu, "cpu")
    Bp, Sp, mpp = 4, 64, 8
    rng = np.random.default_rng(3)
    toks = rng.integers(0, c.vocab, (Bp, Sp)).astype(np.int32)
    table = (1 + np.arange(Bp * mpp, dtype=np.int32)).reshape(Bp, mpp)
    spans = np.array([64, 40, 17, 1], np.int32)
    moe = c.moe is not None
    r_card, r_cpu = [], []
    with _recording_routes(r_card):
        lg_card = _moe_step(p_gpu, c, dev, toks, spans, table)
    with _recording_routes(r_cpu):
        lg_cpu = _moe_step(p_cpu, c, torch.device("cpu"), toks, spans, table)
    require(bool(torch.isfinite(lg_card).all()),
            f"{c.name}: non-finite logits on the card")
    routes = _route_check(r_card, r_cpu, f"{c.name} parity step") \
        if moe else None
    flipped = bool(routes and routes["differences"])
    diff = (lg_card - lg_cpu).abs()
    rel = float(diff.max() / lg_cpu.abs().max())
    line = {"phase": "parity_step_moe", "model": c.name,
            "layers": c.n_layers, "max_abs_err": float(diff.max()),
            "max_rel_err": rel, "rel_tol": PARITY_REL_TOL,
            "routes": routes, "route_flip": flipped}
    require(flipped or rel <= PARITY_REL_TOL,
            f"{c.name}: card vs CPU logits {rel} apart")
    prompts = _serve_prompts(c.vocab, 4, 16, 64, seed=12)
    outs, traces = {}, {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        eng = ContinuousBatchingEngine(
            c, p_gpu if side == "card" else p_cpu,
            **{**SERVE_KW, "max_len": 256}, device=d)
        eng.step_graphs = None        # eager: the routes are recorded
        rec = []
        with _recording_routes(rec):
            reqs = _drive(eng, [p.copy() for p in prompts], 0, 8,
                          f"{c.name} {side} trace")
        outs[side] = [list(r.output_tokens) for r in reqs]
        traces[side] = rec
        del eng
    troutes = _route_check(traces["card"], traces["cpu"],
                           f"{c.name} trace") if moe else None
    tflip = bool(troutes and troutes["differences"])
    same = outs["card"] == outs["cpu"]
    line["trace"] = {"tokens_identical": same, "routes": troutes,
                     "route_flip": tflip,
                     "parted": [i for i, (a, b) in enumerate(
                         zip(outs["card"], outs["cpu"])) if a != b]}
    require(same or tflip, f"{c.name}: greedy tokens differ card vs CPU "
            f"with no route difference: {line['trace']['parted']}")
    if routes:   # the per-difference lists can be long: counts suffice
        for r in (routes, troutes):
            r["n_differences"] = len(r["differences"])
            r["differences"] = r["differences"][:8]
    emit(line)
    return line


def _phase_moe(dev, serve_counts: dict) -> None:
    """Phase 3g: qwen2-moe-a2.7b and granite-moe-1b-a400m at full width
    and depth (bf16, seed-0 random weights) served through the engine's
    step graphs, qwen2 float and with int8 factors and fused projections;
    each with a profiled window (step wall/device ms, tokens/s, launches a
    step by family: the experts' projections counted as one
    expert-batched launch each); gemma2-27b at full width (46 layers)
    served through B1, B2 and the dense attention its softcap takes, with
    a profiled window; then card vs CPU at 2 layers fp32 for all three
    (:func:`_moe_parity`).  Records the serve's launches of the
    expert-batched kernels in ``serve_counts``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    qopts = dict(quantize="int8", fuse_projections=True)
    for arch, variants in (("qwen2-moe-a2.7b", ({}, qopts)),
                           ("granite-moe-1b-a400m", ({},))):
        cfg = _on(get_config(arch))
        mc = cfg.moe
        params = T.init_params(cfg, seed=0, device=dev)
        for opts in variants:
            eng, reqs, counts, dt, n_out, prompt_toks = _serve(
                cfg, params, 8, 32, 256, 32, seed=0, **opts)
            q = bool(opts)
            name = "monarch_fused_q_experts" if q else "monarch_fused_experts"
            line = {"phase": "serve_moe", "model": arch, "options": opts,
                    "dtype": cfg.dtype, "layers": cfg.n_layers,
                    "experts": [mc.n_experts, mc.n_slots, mc.top_k,
                                mc.n_shared],
                    "requests": len(reqs), "prompt_tokens": prompt_toks,
                    "new_tokens": n_out, "seconds": dt,
                    "tokens_per_s": n_out / dt,
                    "steps": eng.stats["mixed_steps"],
                    "kernel_dispatches": eng.stats["kernel_dispatches"],
                    "dense_fallbacks": eng.stats["dense_fallbacks"],
                    "launches": counts,
                    "expert_keys": sorted(
                        eng.params["decoder"]["layers"]["moe"]["experts"]),
                    "graphs": _graphs_replayed(eng, f"{arch} serve")}
            emit(line)
            other = "monarch_fused_experts" if q else \
                "monarch_fused_q_experts"
            require(counts[name] > 0 and counts[other] == 0
                    and counts["paged_attention_span"] > 0
                    and eng.stats["dense_fallbacks"] == 0,
                    f"{arch} {opts}: the experts must run {name} only, "
                    f"attention the span kernel: {counts}")
            serve_counts[name] = serve_counts.get(name, 0) + counts[name]
            del eng
            prof = _profile_serve(cfg, params, **opts)
            emit({"phase": "serve_profile_moe", "model": arch,
                  "options": opts, **prof})
            # one launch a projection over the expert axis: up, gate and
            # down (up+gate fused: two), never one an expert; the single
            # products: attention (q, k, v, o; fused: qkv and o, or q, kv
            # and o under GQA) and each shared expert's projections
            ffn = 2 if q else 3
            attn = 4 if not q else 2 if cfg.n_heads == cfg.n_kv_heads else 3
            per_layer = {name: ffn,
                         "monarch_fused_q" if q else "monarch_fused":
                         attn + ffn * mc.n_shared}
            for wname, w in prof.items():
                got = {k: w["launches_per_step"].get(k, 0) / cfg.n_layers
                       for k in per_layer}
                require(got == per_layer, f"{arch} {opts} {wname}: launches "
                        f"a layer {got}, not {per_layer}")
        del params
        torch.cuda.empty_cache()
    # gemma2-27b: sandwich norms, local/global windows, softcaps, GeGLU
    cfg = _on(get_config("gemma2-27b"))
    params = T.init_params(cfg, seed=0, device=dev)
    kw = dict(max_len=512)
    eng, reqs, counts, dt, n_out, prompt_toks = _serve(
        cfg, params, 8, 32, 256, 32, seed=0, **kw)
    emit({"phase": "serve_gemma2", "model": cfg.name, "dtype": cfg.dtype,
          "layers": cfg.n_layers, "requests": len(reqs),
          "prompt_tokens": prompt_toks, "new_tokens": n_out, "seconds": dt,
          "tokens_per_s": n_out / dt, "steps": eng.stats["mixed_steps"],
          "dense_fallback_softcap": eng.stats["dense_fallback_softcap"],
          "launches": counts, "graphs": _graphs_replayed(eng, "gemma2 serve")})
    require(counts["monarch_fused"] > 0 and counts["bdmm"] > 0
            and counts["paged_attention_span"] == 0
            and eng.stats["dense_fallback_softcap"]
            == eng.stats["mixed_steps"],
            f"gemma2-27b must run B1 and B2 and its softcapped attention "
            f"dense: {counts}")
    del eng
    emit({"phase": "serve_profile_gemma2", **_profile_serve(cfg, params,
                                                            **kw)})
    del params
    torch.cuda.empty_cache()
    for arch in ("qwen2-moe-a2.7b", "granite-moe-1b-a400m", "gemma2-27b"):
        _moe_parity(_on(get_config(arch)), dev)
        torch.cuda.empty_cache()


# -- phase 3h: Mamba2, the Zamba2 hybrid, the encoder-decoder and the vision
# frontend --------------------------------------------------------------------

def _on(cfg):
    """``cfg`` with the kernels on: every Monarch projection through B1/B2
    (``backend="pallas"``), attention through the span kernel."""
    return dataclasses.replace(cfg, paged_kernel=True,
                               monarch=dataclasses.replace(
                                   cfg.monarch, backend="pallas"))


def _counted() -> dict:
    """The launch counters that moved since their last reset."""
    from repro_torch.kernels import launches

    return {k: v for k, v in launches().items() if v}


def _flat(tree, prefix: str = "") -> dict:
    """A nested dict's leaves by their ``a/b/c`` paths."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _same_trees(a, b) -> bool:
    import torch

    fa, fb = _flat(a), _flat(b)
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k])
                                          for k in fa)


@contextlib.contextmanager
def _recording_stages(into: list):
    """The residual stream after every Mamba layer and attention block, in
    call order (the encoder's blocks, then the decoder's), as fp32 host
    copies: the stages a card-vs-CPU reading is traced through."""
    from repro_torch.models import transformer as T

    mamba, block = T._mamba_layer, T.attn_block_apply

    def rec_mamba(*a, **k):
        out = mamba(*a, **k)
        into.append(out.float().cpu())
        return out

    def rec_block(*a, **k):
        out = block(*a, **k)
        into.append(out.float().cpu())
        return out

    T._mamba_layer, T.attn_block_apply = rec_mamba, rec_block
    try:
        yield into
    finally:
        T._mamba_layer, T.attn_block_apply = mamba, block


def _stage_report(card: list, cpu: list) -> dict:
    """Each stage card vs CPU (relative to the CPU's largest value); the
    first stage where they differ, and the first whose difference is more
    than twice the stage's before it (``first_jump``, as parity_step)."""
    r = [_rel(a, b) for a, b in zip(card, cpu)]
    return {"card_vs_cpu": r,
            "first_differs": next((i for i, x in enumerate(r) if x > 0),
                                  None),
            "first_jump": next((i for i in range(1, len(r))
                                if 0 < 2 * r[i - 1] < r[i]), None)}


def _parity_line(name: str, cfg, readings: dict, stages: dict) -> dict:
    """Emit a card-vs-CPU line; every reading within PARITY_REL_TOL."""
    worst = max(readings.values())
    line = {"phase": "parity_families", "model": name,
            "layers": cfg.n_layers, "readings_rel": readings,
            "max_rel_err": worst, "rel_tol": PARITY_REL_TOL,
            "stages": _stage_report(stages["card"], stages["cpu"])}
    emit(line)
    require(worst <= PARITY_REL_TOL,
            f"{name}: card vs CPU {worst} apart (first_jump at stage "
            f"{line['stages']['first_jump']}): {readings}")
    return line


def _ssm_parity(cfg, dev, n_layers: int) -> dict:
    """``cfg`` at full width cut to ``n_layers``, fp32, seeded random
    weights made on the card and copied to the CPU: a forward's logits (B
    = 2, S = 64), then 8 decode steps from zeroed states (each step's
    logits) and the final states (the Mamba ``conv`` and ``ssm``, a
    hybrid's rings), card vs CPU, each within PARITY_REL_TOL."""
    import torch

    from repro_torch import tree_to
    from repro_torch.models import transformer as T

    c = dataclasses.replace(cfg, n_layers=n_layers, dtype="float32")
    p_gpu = T.init_params(c, seed=3, device=dev)
    sides = (("card", dev, p_gpu), ("cpu", torch.device("cpu"),
                                    tree_to(p_gpu, "cpu")))
    toks = torch.randint(0, c.vocab, (2, 64),
                         generator=torch.Generator().manual_seed(5))
    got, stages = {}, {}
    for side, d, p in sides:
        rec: list = []
        with _recording_stages(rec):
            lg, _ = T.forward(p, {"tokens": toks.to(d)}, c, train=False)
        cache = T.init_decode_cache(c, 2, 16, device=d)
        steps = [T.decode_step(p, toks[:, t].to(d), cache, c)[0][
            :, :c.vocab].float().cpu() for t in range(8)]
        got[side] = (lg[..., :c.vocab].float().cpu(), torch.stack(steps, 1),
                     _flat(tree_to(cache, "cpu")))
        stages[side] = rec
    (f_a, d_a, s_a), (f_b, d_b, s_b) = got["card"], got["cpu"]
    readings = {"forward_logits": _rel(f_a, f_b),
                "decode_logits": _rel(d_a, d_b)}
    for path, leaf in s_b.items():
        if leaf.is_floating_point():
            readings[f"state/{path}"] = _rel(s_a[path], leaf)
        else:
            require(torch.equal(s_a[path], leaf), f"{c.name}: {path}")
    return _parity_line(c.name, c, readings, stages)


def _phase_ssm(dev, arch: str, parity_layers: int) -> dict:
    """Phase 3h (a, b): ``arch`` (mamba2-2.7b or zamba2-7b) at full width
    and depth, seed-0 random fp32 weights cast to bf16 as the reference's
    serve step casts them (``launch.steps._compute_cast``; its Mamba
    stacks refuse bf16 activations over fp32 weights, their layer scan's
    carry turning fp32: ``tests/test_torch_mamba.py``), through the
    legacy ``ServeEngine``: the prompt token by token through the decode
    graph (the Mamba states written in place), greedy and sampled
    generates, launches a generate = an eager decode step's times its
    steps, one host sync a generate, a replay ``torch.equal`` to an eager
    ``decode_step``; a profiled decode window; a profiled forward at S =
    512 (chunks of 256) with ``ssd_chunked``'s device ms; then card vs CPU
    at ``parity_layers`` (:func:`_ssm_parity`)."""
    import torch

    from repro_torch import tree_map
    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.steps import _compute_cast
    from repro_torch.models import mamba2 as M
    from repro_torch.models import transformer as T
    from repro_torch.serving import GenerationConfig, ServeEngine

    cfg = _on(get_config(arch))
    params = _compute_cast(T.init_params(cfg, seed=0, device=dev), cfg)
    B, S, n = SSM_BATCH, SSM_PROMPT, SSM_NEW
    eng = ServeEngine(cfg, params, max_len=S + n, device=dev)
    require(eng._prefill is None, f"{arch}: the prompt must run token by "
            f"token")
    prompts = torch.randint(0, cfg.vocab, (B, S),
                            generator=torch.Generator().manual_seed(0))
    runs = {"greedy": GenerationConfig(max_new_tokens=n),
            "sampled": GenerationConfig(max_new_tokens=n,
                                        temperature=SAMPLE_TEMPERATURE,
                                        seed=0)}
    eng.generate(prompts, runs["greedy"])     # captures the decode graph
    g = eng._decode.graphs
    ring = eng._rings[B]
    require(g.captures == 1 and len(g.buckets) == 1,
            f"{arch}: one decode graph: {g.buckets}")
    # an eager decode step's launches, on a clone of the states
    tok = prompts[:, 0].to(dev, torch.int32)
    _sync(dev)
    reset_launches()
    T.decode_step(eng.params, tok, tree_map(torch.clone, ring), cfg)
    _sync(dev)
    per_step = _counted()
    require(per_step.get("monarch_fused", 0) > 0,
            f"{arch}: a decode step must run B1: {per_step}")
    steps = S + n - 1
    want = {k: v * steps for k, v in per_step.items()}
    want["sample_tokens"] = n
    out: dict = {"model": arch, "dtype": cfg.dtype, "layers": cfg.n_layers,
                 "params_dtype": "bfloat16 (the serve step's cast)",
                 "B": B, "prompt": S, "new_tokens": n,
                 "max_len": eng.max_len, "buckets": g.buckets,
                 "launches_per_decode_step": per_step}
    for name, gc in runs.items():
        _sync(dev)
        reset_launches()
        replays = g.replays
        t0 = time.perf_counter()
        toks = eng.generate(prompts, gc)
        dt = time.perf_counter() - t0
        counts = _counted()
        out[name] = {"seconds": dt, "tokens_per_s": B * n / dt,
                     "decode_steps": steps, "ms_per_step": dt * 1e3 / steps,
                     "launches": counts, "replays": g.replays - replays,
                     "tokens": toks[:2].tolist()}
        require(tuple(toks.shape) == (B, n) and int(toks.min()) >= 0
                and int(toks.max()) < cfg.vocab,
                f"{arch} {name}: tokens {tuple(toks.shape)} out of the vocab")
        require(counts == want and g.replays - replays == steps,
                f"{arch} {name}: launches {counts} (want {want}), replays "
                f"{g.replays - replays} (want {steps})")
        if name == "greedy":
            greedy_toks = toks
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.generate(prompts, runs["sampled"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    out["host_syncs_per_generate"] = sum(
        "called a synchronizing CUDA operation" in str(w.message)
        for w in caught)
    require(out["host_syncs_per_generate"] == 1,
            f"{arch}: {out['host_syncs_per_generate']} host syncs a generate")
    # the replay against an eager decode_step on a clone of the states
    tok = greedy_toks[:, -1].to(dev)
    c_eager = tree_map(torch.clone, ring)
    lg_graph, _ = eng._decode(eng.params, tok, ring)
    lg_eager, _ = T.decode_step(eng.params, tok, c_eager, cfg)
    _sync(dev)
    out["replay_vs_eager"] = {"logits": torch.equal(lg_graph, lg_eager),
                              "states": _same_trees(ring, c_eager)}
    require(all(out["replay_vs_eager"].values()),
            f"{arch}: replay vs eager {out['replay_vs_eager']}")

    def graph_step():
        eng._decode(eng.params, tok, ring)

    win = _ring_window(dev, graph_step, 8)
    seen = win["kernels_per_step_profiled"]
    require(seen["monarch_fused_kernel"] >= PROFILED_SHARE
            * per_step.get("monarch_fused", 0)
            and seen["bdmm_"] >= PROFILED_SHARE * per_step.get("bdmm", 0),
            f"{arch}: the profiler shows {seen} a step, the counters "
            f"{per_step}")
    out["decode_graph"] = win
    # the chunked forward at S = 512 (two chunks of 256), and ssd_chunked
    # alone on the first layer's inputs
    toks = torch.randint(0, cfg.vocab, (B, 512),
                         generator=torch.Generator().manual_seed(2)).to(dev)
    first: list = []
    ssd = M.ssd_chunked

    def capture(*a, **k):
        if not first:
            first.append((a, k))
        return ssd(*a, **k)

    M.ssd_chunked = capture
    try:
        fwd_ms = _device_ms(lambda: T.forward(eng.params, {"tokens": toks},
                                              cfg, train=False), n=2)
    finally:
        M.ssd_chunked = ssd
    a, k = first[0]
    ssd_ms = _device_ms(lambda: ssd(*a, **k), n=5)
    out["forward_S512"] = {
        "B": B, "S": 512, "chunk": cfg.ssm.chunk, "device_ms": fwd_ms,
        "ssd_chunked_ms_a_layer": ssd_ms,
        "ssd_chunked_ms": ssd_ms * cfg.n_layers,
        "ssd_chunked_share": ssd_ms * cfg.n_layers / fwd_ms}
    emit({"phase": "serve_ssm", **out})
    del eng, params, ring, c_eager
    torch.cuda.empty_cache()
    out["parity"] = _ssm_parity(cfg, dev, parity_layers)
    torch.cuda.empty_cache()
    return out


def _encdec_parity(cfg, dev) -> dict:
    """seamless-m4t-large-v2 at full width cut to 2 + 2 layers, fp32:
    ``_encode`` of 64 frames, ``make_prefill_step``'s logits on an 8-token
    decoder prompt, then the prompt token by token through
    ``make_decode_step(enc_out=...)`` (each step's logits) and the ring,
    card vs CPU, each within PARITY_REL_TOL."""
    import torch

    from repro_torch import tree_to
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import transformer as T

    c = dataclasses.replace(cfg, n_layers=2, n_enc_layers=2,
                            dtype="float32")
    p_gpu = T.init_params(c, seed=3, device=dev)
    gen = torch.Generator().manual_seed(6)
    frames = torch.randn((2, 64, c.d_model), generator=gen)
    toks = torch.randint(0, c.vocab, (2, 8), generator=gen)
    got, stages = {}, {}
    for side, d, p in (("card", dev, p_gpu),
                       ("cpu", torch.device("cpu"), tree_to(p_gpu, "cpu"))):
        batch = {"tokens": toks.to(d), "enc_embeds": frames.to(d)}
        rec: list = []
        with _recording_stages(rec):
            enc = T._encode(p, batch, c)
            pre = make_prefill_step(c)(p, batch)
        cache = T.init_decode_cache(c, 2, 16, device=d)
        step = make_decode_step(c)
        steps = [step(p, toks[:, t].to(d), cache, enc)[0][:, :c.vocab]
                 .float().cpu() for t in range(toks.shape[1])]
        got[side] = (enc.float().cpu(), pre[:, :c.vocab].float().cpu(),
                     torch.stack(steps, 1), _flat(tree_to(cache, "cpu")))
        stages[side] = rec
    a, b = got["card"], got["cpu"]
    readings = {"enc_out": _rel(a[0], b[0]), "prefill_logits": _rel(a[1],
                                                                    b[1]),
                "decode_logits": _rel(a[2], b[2])}
    for path, leaf in b[3].items():
        if leaf.is_floating_point():
            readings[f"ring/{path}"] = _rel(a[3][path], leaf)
    return _parity_line(c.name, c, readings, stages)


def _phase_encdec(dev) -> dict:
    """Phase 3h (c): seamless-m4t-large-v2 at full width (24 + 24 layers,
    vocab 256206, seed-0 fp32 weights, bf16 steps): ``enc_out`` from
    ``_encode`` on ENC_BATCH x n_frontend_tokens frames (the stubbed
    audio frontend); ``make_prefill_step``'s logits on an ENC_PROMPT-token
    decoder prompt; the same prompt token by token through
    ``make_decode_step(enc_out=...)`` into a ring (its last logits against
    the prefill's: a reading, bf16) and ENC_NEW greedy tokens drawn by X3
    (V = 256256); a decode
    step's device ms and the cross-attention K/V projections' share (B1
    over every frame in each of the 24 layers, recomputed at every step
    as in the reference); then card vs CPU at 2 + 2 layers
    (:func:`_encdec_parity`)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.linear import linear_apply
    from repro_torch.kernels import reset_launches
    from repro_torch.kernels.sample import sample_block
    from repro_torch.launch.steps import (_compute_cast, make_decode_step,
                                          make_prefill_step)
    from repro_torch.models import transformer as T

    cfg = _on(get_config("seamless-m4t-large-v2"))
    params = T.init_params(cfg, seed=0, device=dev)
    B, F_, S, n = ENC_BATCH, cfg.n_frontend_tokens, ENC_PROMPT, ENC_NEW
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    frames = torch.randn((B, F_, cfg.d_model), generator=gen, device=dev)
    prompts = torch.randint(0, cfg.vocab, (B, S),
                            generator=torch.Generator().manual_seed(1)).to(
        dev)
    batch = {"tokens": prompts, "enc_embeds": frames}
    out: dict = {"model": cfg.name, "dtype": cfg.dtype,
                 "layers": [cfg.n_enc_layers, cfg.n_layers], "B": B,
                 "frames": F_, "prompt": S, "new_tokens": n}
    _sync(dev)
    reset_launches()
    t0 = time.perf_counter()
    enc_out = T._encode(_compute_cast(params, cfg), batch, cfg)
    _sync(dev)
    out["encode"] = {"seconds": time.perf_counter() - t0,
                     "launches": _counted()}
    require(tuple(enc_out.shape) == (B, F_, cfg.d_model)
            and bool(torch.isfinite(enc_out).all()),
            f"seamless: enc_out {tuple(enc_out.shape)}")
    reset_launches()
    t0 = time.perf_counter()
    pre = make_prefill_step(cfg)(params, batch)
    _sync(dev)
    out["prefill"] = {"seconds": time.perf_counter() - t0,
                      "launches": _counted()}
    step = make_decode_step(cfg)
    cache = T.init_decode_cache(cfg, B, S + n + 16, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    for t in range(S):
        lg, _ = step(params, prompts[:, t].contiguous(), cache, enc_out)
    _sync(dev)
    out["prompt_by_token"] = {"seconds": time.perf_counter() - t0,
                              "launches": _counted(),
                              "last_logits_vs_prefill_rel": _rel(
                                  lg[:, :cfg.vocab].float(),
                                  pre[:, :cfg.vocab].float())}
    # the new tokens drawn by X3 (greedy, its block draw as the
    # ServeEngine draws them) over the padded vocabulary of 256256
    temps = torch.zeros(B, device=dev)
    key = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    toks = []
    reset_launches()
    t0 = time.perf_counter()
    for i in range(n):
        tok = sample_block(lg, temps, key, False)
        toks.append(tok)
        if i < n - 1:
            lg, _ = step(params, tok, cache, enc_out)
    toks = torch.stack(toks, 1).cpu()
    out["greedy"] = {"seconds": time.perf_counter() - t0,
                     "launches": _counted(), "vocab_padded": lg.shape[-1],
                     "tokens": toks[:2].tolist()}
    require(bool(torch.isfinite(pre).all()) and int(toks.max()) < cfg.vocab
            and out["prompt_by_token"]["launches"].get("monarch_fused", 0)
            > 0 and out["greedy"]["launches"].get("sample_tokens") == n,
            f"seamless: {out['prompt_by_token']}, {out['greedy']}")
    # a decode step, and the cross-attention's K and V projections alone
    cast = _compute_cast(params, cfg)
    xattn = [T.layer_params(cast["decoder"]["layers"], i)["xattn"]
             for i in range(cfg.n_layers)]

    def cross_kv():
        for p in xattn:
            for name in ("wk", "wv"):
                linear_apply(p[name], enc_out, backend="pallas")

    step_ms = _device_ms(lambda: step(params, tok, cache, enc_out), n=3)
    kv_ms = _device_ms(cross_kv, n=3)
    out["decode_step"] = {"device_ms": step_ms, "cross_kv_device_ms": kv_ms,
                          "cross_kv_share": kv_ms / step_ms,
                          "cross_kv_rows": B * F_}
    emit({"phase": "serve_encdec", **out})
    del params, cast, xattn, enc_out, cache
    torch.cuda.empty_cache()
    out["parity"] = _encdec_parity(cfg, dev)
    return out


def _phase_vlm(dev) -> dict:
    """Phase 3h (d): internvl2-76b at full width and depth (80 layers, d
    8192, GQA 64 / 8, hd 128, vocab 128256; seed-0 fp32 weights, bf16
    activations): a prefill with its n_frontend_tokens patch embeddings
    (the stubbed vision frontend) before VLM_TEXT text tokens a row; the
    continuous-batching engine's text serve (B1, B2 staged, B3, X3) with
    its replays ``torch.equal`` to eager steps and a profiled window; then
    card vs CPU at 2 layers (:func:`_moe_parity`, which needs no MoE)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launches
    from repro_torch.models import transformer as T

    cfg = _on(get_config("internvl2-76b"))
    params = T.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    B = 2
    patches = torch.randn((B, cfg.n_frontend_tokens, cfg.d_model),
                          generator=gen, device=dev)
    toks = torch.randint(0, cfg.vocab, (B, VLM_TEXT),
                         generator=torch.Generator().manual_seed(3)).to(dev)
    batch = {"tokens": toks, "patch_embeds": patches}
    T.prefill(params, batch, cfg)
    _sync(dev)
    reset_launches()
    t0 = time.perf_counter()
    lg = T.prefill(params, batch, cfg)
    _sync(dev)
    pre = {"B": B, "patches": cfg.n_frontend_tokens, "text": VLM_TEXT,
           "seconds": time.perf_counter() - t0, "launches": _counted(),
           "device_ms": _device_ms(lambda: T.prefill(params, batch, cfg),
                                   n=2)}
    require(tuple(lg.shape) == (B, cfg.vocab_padded)
            and bool(torch.isfinite(lg[:, :cfg.vocab]).all())
            and pre["launches"].get("bdmm", 0) > 0,
            f"internvl2 prefill: {pre}")
    eng, reqs, counts, dt, n_out, prompt_toks = _serve(
        cfg, params, 8, 32, 256, 32, seed=0)
    line = {"phase": "serve_vlm", "model": cfg.name, "dtype": cfg.dtype,
            "layers": cfg.n_layers,
            "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.hd],
            "prefill_patch_embeds": pre, "requests": len(reqs),
            "prompt_tokens": prompt_toks, "new_tokens": n_out,
            "seconds": dt, "tokens_per_s": n_out / dt,
            "steps": eng.stats["mixed_steps"],
            "dense_fallbacks": eng.stats["dense_fallbacks"],
            "launches": counts,
            "graphs": _graphs_replayed(eng, "internvl2 serve")}
    emit(line)
    require(counts["bdmm"] > 0 and counts["paged_attention_span"] > 0
            and counts["sample_tokens"] > 0
            and eng.stats["dense_fallbacks"] == 0,
            f"internvl2-76b must run B2, B3 and X3: {counts}")
    del eng
    line["profile"] = _profile_serve(cfg, params)
    emit({"phase": "serve_profile_vlm", "model": cfg.name,
          **line["profile"]})
    del params
    torch.cuda.empty_cache()
    line["parity"] = _moe_parity(cfg, dev)
    torch.cuda.empty_cache()
    return line


def _sink_determinism(dev) -> list:
    """ROADMAP §C 4 on the card: qwen2-moe-a2.7b with the dense attention
    (``paged_kernel=False``), at ``.reduced()`` (fp32) and at full width
    cut to 2 layers (bf16): one mixed step whose padding positions (short
    spans, an empty row, table entries past the span at the sink) collide
    on the sink page, run twice on fresh pools: the logits, every page
    (the sink's included) and every layer's routes ``torch.equal``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    full = get_config("qwen2-moe-a2.7b")
    out = []
    for name, c in (("reduced", full.reduced()),
                    ("full width, 2 layers", dataclasses.replace(
                        full, n_layers=2))):
        c = dataclasses.replace(_on(c), paged_kernel=False)
        params = T.init_params(c, seed=0, device=dev)
        B, S, pg = 8, 64, 16
        rng = np.random.default_rng(13)
        toks = torch.from_numpy(rng.integers(0, c.vocab, (B, S)).astype(
            np.int32)).to(dev)
        spans = torch.tensor([64, 40, 17, 1, 0, 9, 0, 33],
                             dtype=torch.int32, device=dev)
        table = torch.zeros((B, S // pg), dtype=torch.int32, device=dev)
        for b, sp in enumerate(spans.tolist()):
            for j in range(-(-sp // pg)):
                table[b, j] = 1 + b * (S // pg) + j
        runs = []
        for _ in range(2):
            pool = T.init_paged_pool(c, 1 + B * (S // pg), pg, device=dev)
            routes: list = []
            with _recording_routes(routes):
                lg, _ = T.paged_mixed_step(
                    params, toks, torch.zeros(B, dtype=torch.int32,
                                              device=dev),
                    spans, table, pool, c)
            runs.append((lg.clone(), pool, routes))
        (l0, p0, r0), (l1, p1, r1) = runs
        same = {"logits": torch.equal(l0, l1), "pages": _same_trees(p0, p1),
                "routes": len(r0) == len(r1) and all(
                    torch.equal(a["idx"], b["idx"])
                    and torch.equal(a["kept"], b["kept"])
                    for a, b in zip(r0, r1))}
        line = {"phase": "sink_determinism", "model": c.name, "cut": name,
                "dtype": c.dtype, "padding_writes": int(
                    (B * S - spans.sum()).item()), "equal": same}
        emit(line)
        require(all(same.values()), f"§C 4: two runs of a dense MoE step "
                f"differ: {line}")
        out.append(line)
        del params
        torch.cuda.empty_cache()
    return out


def _phase_families(dev) -> None:
    """Phase 3h: the four configs of the Mamba2, hybrid, encoder-decoder
    and vision families, then the sink writes' determinism (§C 4) and the
    serve_decode example at ``--arch mamba2-2_7b``."""
    import torch

    _phase_ssm(dev, "mamba2-2.7b", parity_layers=2)
    # zamba2-7b card vs CPU at its .reduced() depth: one group and a tail
    from repro_torch.configs import get_config
    _phase_ssm(dev, "zamba2-7b",
               parity_layers=get_config("zamba2-7b").shared_attn_every + 1)
    _phase_encdec(dev)
    _phase_vlm(dev)
    _sink_determinism(dev)
    torch.cuda.empty_cache()
    _example_runs(dev, variants=(["--arch", "mamba2-2_7b"],))


# -- phase 3i: training ----------------------------------------------------

def _grad_report(card: dict, cpu: dict) -> dict:
    """Each leaf's max |card - CPU| over the CPU's max |g|, the worst
    leaf named."""
    worst = ("", -1.0)
    for path, g in cpu.items():
        scale = float(g.abs().max())
        rel = float((card[path] - g).abs().max()) / max(scale, 1e-30)
        if rel > worst[1]:
            worst = (path, rel)
    return {"worst_leaf": worst[0], "worst_rel_to_max": worst[1],
            "leaves": len(cpu)}


@contextlib.contextmanager
def _cpu_flush_denormals():
    """The CPU on one thread with denormals flushed to zero.  A peaked
    softmax over ~50k classes (mamba2-2.7b's random init: loss ~82)
    leaves probabilities below fp32's normal range in the backward pass,
    which x86 multiplies ~100x slower; ``set_flush_denormal`` flushes
    them on the calling thread only, so the CPU side runs on that one.
    The flushed values are below 1.2e-38, far under any limit here."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)
        torch.set_num_threads(n)


TRAIN_LR, TRAIN_B1 = 1e-3, 0.9     # phase 3i (a)'s AdamW, clipping off


def _train_parity_setup(arch: str, dev):
    """Phase 3i (a)'s inputs: ``arch`` at full width cut to
    TRAIN_PARITY_LAYERS, fp32, seed-3 random weights made on the card,
    one batch of TRAIN_PARITY_BATCH from the data pipeline."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batches
    from repro_torch.models import transformer as T

    c = dataclasses.replace(get_config(arch), n_layers=TRAIN_PARITY_LAYERS,
                            dtype="float32")
    B, S = TRAIN_PARITY_BATCH
    batch = next(make_batches(DataConfig(vocab=c.vocab, seq_len=S,
                                         global_batch=B, seed=7),
                              prefetch=0))
    return c, batch, T.init_params(c, seed=3, device=dev)


def _train_parity_side(c, params, batch) -> dict:
    """One ``make_train_step`` step (AdamW, clipping off) on the params'
    device: its loss, its gradients read from the step's first moment
    (one step from zeros leaves ``mu = (1 - b1) g``), the stepped
    parameters, an MoE model's routes.  The CPU runs it on one thread with
    denormals flushed (``_cpu_flush_denormals``)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import leaves_with_paths

    routes: list = []
    init, step = make_train_step(
        c, adamw(lr=TRAIN_LR, b1=TRAIN_B1, clip_norm=None))
    dev = leaves_with_paths(params)[0][1].device
    with contextlib.ExitStack() as ctx:
        if c.moe:
            ctx.enter_context(_recording_routes(routes))
        if dev.type == "cpu":
            ctx.enter_context(_cpu_flush_denormals())
        t0 = time.perf_counter()
        state, m = step(init(params=params), batch)
        loss = float(m["loss"])
        seconds = time.perf_counter() - t0
    return dict(
        loss=loss, lb=float(m["lb_loss"]), routes=routes, seconds=seconds,
        step=int(state["opt"].step),
        grads={"/".join(k): v.float().cpu() / (1 - TRAIN_B1)
               for k, v in leaves_with_paths(state["opt"].mu)},
        params={"/".join(k): v.float().cpu()
                for k, v in leaves_with_paths(state["params"])})


def _train_parity(arch: str, c, a: dict, b: dict, card: str) -> dict:
    """Phase 3i (a): the card's step (``a``) against the CPU's (``b``):
    the loss within PARITY_REL_TOL, each gradient leaf within
    TRAIN_GRAD_TOL of its own max |g|, an MoE model's routes first
    (``_route_check``).  The stepped parameters' distance over lr is a
    reading: AdamW's first step is about lr * sign(g), so a gradient
    within rounding of 0 moves its parameter by up to 2 lr."""
    B, S = TRAIN_PARITY_BATCH
    line = {"phase": "train_parity", "model": arch,
            "layers": TRAIN_PARITY_LAYERS, "batch": [B, S],
            "dtype": "float32", "remat": c.remat,
            "loss": {"card": a["loss"], "cpu": b["loss"],
                     "rel": abs(a["loss"] - b["loss"]) / abs(b["loss"])},
            "lb_loss": {"card": a["lb"], "cpu": b["lb"]},
            "grads": _grad_report(a["grads"], b["grads"]),
            "stepped_params_max_abs_over_lr": max(
                float((a["params"][k] - v).abs().max()) for k, v in
                b["params"].items()) / TRAIN_LR,
            "card_step_seconds": a["seconds"],
            "cpu_step_seconds": b["seconds"],
            "loss_tol": PARITY_REL_TOL, "grad_tol": TRAIN_GRAD_TOL,
            "card": card}
    if c.moe:
        line["routes"] = _route_check(a["routes"], b["routes"],
                                      f"train {arch}")
    emit(line)
    require(a["step"] == b["step"] == 1, f"train {arch}: no step taken")
    require(line["loss"]["rel"] <= PARITY_REL_TOL,
            f"train {arch}: loss card vs CPU {line['loss']}")
    require(line["grads"]["worst_rel_to_max"] <= TRAIN_GRAD_TOL,
            f"train {arch}: gradients card vs CPU {line['grads']}")
    return line


def _train_readings(cfg, batch, dev, card: str) -> dict:
    """One train step of ``cfg`` under each remat policy, outside the
    deterministic mode: wall ms (synchronized), tokens/s, peak memory
    (``max_memory_allocated`` over the step, and that less what was
    allocated before the train state was made: the step's own peak, its
    state included, without what earlier phases keep alive), the step's
    device ms and its top 5 device ops from torch.profiler.  Earlier
    phases' garbage is collected first: a reference cycle freed during
    the step (a finished Trainer) would otherwise leave the card's
    memory ``before`` the state and take it off the step's peak."""
    import gc

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    out = {}
    tokens = int(np.prod(batch["tokens"].shape))
    for remat in ("full", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        init, step = make_train_step(c, adamw(lr=1e-4))
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        state = init(0, device=dev)
        state, m = step(state, batch)          # warm
        float(m["loss"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state, m = step(state, batch)
            float(m["loss"])
            torch.cuda.synchronize()
        ops = sorted(((getattr(e, "self_device_time_total", None)
                       or e.self_cuda_time_total, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
        out[remat] = {"step_wall_ms": wall * 1e3,
                      "step_device_ms": sum(t for t, _ in ops) / 1e3,
                      "tokens_per_s": tokens / wall,
                      "max_memory_allocated_gb": peak / 1e9,
                      "allocated_before_gb": before / 1e9,
                      "step_peak_gb": (peak - before) / 1e9,
                      "top5_device_ops_ms": [[k[:160], t / 1e3]
                                             for t, k in ops[:5]]}
        del state, m
        torch.cuda.empty_cache()
    emit({"phase": "train_readings", "model": cfg.name, "dtype": cfg.dtype,
          "batch": list(batch["tokens"].shape), **out, "card": card})
    return out


def _train_gpt2_cfg():
    """gpt2-medium as phase 3i (b) trains it: the config as published."""
    from repro_torch.configs import get_config

    cfg = get_config("gpt2-medium")
    require(cfg.n_layers == 24 and cfg.d_model == 1024
            and cfg.dtype == "bfloat16" and cfg.remat == "full"
            and cfg.monarch.enable and cfg.monarch.backend == "einsum",
            f"gpt2-medium is not the config phase 3i trains: {cfg}")
    return cfg


def _train_gpt2(dev, card: str) -> list:
    """Phase 3i (b): gpt2-medium at full width and depth (24 layers, d
    1024, the paper's Monarch projections on the einsum backend, bf16
    compute over fp32 masters, remat "full") trained by the ``Trainer``
    for TRAIN_CFG's 30 steps on the synthetic corpus (TRAIN_DATA) under
    ``torch.use_deterministic_algorithms``: its loss must fall (the last
    5 steps' mean below the first 5's); then the step-20 checkpoint
    restored into a fresh ``Trainer`` gives steps 20-29's losses again,
    equal (1e-5 relative, each op named, where an op has no
    deterministic version).  The CPU side of (a) runs meanwhile, so the
    run's step times are readings under that load; ``_train_readings``
    times the step alone.  Returns the batches."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.data import DataConfig, make_batches
    from repro_torch.train import Trainer, TrainerConfig

    cfg = _train_gpt2_cfg()
    it = make_batches(DataConfig(**TRAIN_DATA))
    batches = [next(it) for _ in range(TRAIN_CFG["steps"])]
    it.close()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    tcfg = TrainerConfig(**TRAIN_CFG, ckpt_dir=str(TRAIN_DIR / "run"))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer = Trainer(cfg, tcfg, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.run(iter(batches))
            run_s = time.perf_counter() - t0
            src = TRAIN_DIR / "run" / f"step_{TRAIN_RESUME_AT:08d}"
            dst = TRAIN_DIR / "resume" / src.name
            shutil.copytree(src, dst)
            resumed = Trainer(cfg, dataclasses.replace(
                tcfg, ckpt_dir=str(dst.parent)), device=dev)
            t0 = time.perf_counter()
            resumed.run(iter(batches[TRAIN_RESUME_AT:]))
            resume_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split(" does not have a deterministic")[0]
                     for w in caught
                     if "does not have a deterministic" in str(w.message)})
    losses = [h["loss"] for h in trainer.history]
    again = [h["loss"] for h in resumed.history]
    want = losses[TRAIN_RESUME_AT:]
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    diff = max(abs(a - b) / abs(b) for a, b in zip(again, want))
    walls = [h["step_time_s"] * 1e3 for h in trainer.history[1:]]
    line = {"phase": "train_gpt2", "model": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "dtype": cfg.dtype, "remat": cfg.remat,
            "data": TRAIN_DATA, "trainer": TRAIN_CFG, "losses": losses,
            "first5_mean": first5, "last5_mean": last5,
            "resumed_from": TRAIN_RESUME_AT,
            "resumed_first_step": resumed.history[0]["step"],
            "resumed_losses": again, "resumed_equal": again == want,
            "resumed_max_rel": diff, "nondeterministic_ops": nondet,
            "run_seconds": run_s, "resume_seconds": resume_s,
            "deterministic_step_wall_ms_median_cpu_busy":
                float(np.median(walls)),
            "card": card}
    emit(line)
    require(last5 < first5, f"gpt2-medium's loss did not fall: {first5} -> "
            f"{last5}")
    require(resumed.history[0]["step"] == TRAIN_RESUME_AT
            and len(again) == len(want),
            "the resumed Trainer did not start at its checkpoint")
    if nondet:
        require(diff <= PARITY_REL_TOL, f"the resumed run's losses differ "
                f"by {diff} (ops without a deterministic version: {nondet})")
    else:
        require(again == want, f"the resumed run's losses differ: {again} "
                f"vs {want}")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return batches


def _train_refusal(dev, card: str) -> dict:
    """Phase 3i (c): a Monarch layer on the kernel backend whose factors
    require grad refuses autograd on the card (``RuntimeError``), where
    it would otherwise fill its output through ctypes with no grad_fn."""
    import torch

    from repro_torch.core.linear import linear_apply
    from repro_torch.core.monarch import init_monarch, make_dims
    from repro_torch.kernels import launches

    g = torch.Generator(device=dev).manual_seed(0)
    f = init_monarch(g, make_dims(1024, 1024, policy="paper"), device=dev)
    L = f["L"].requires_grad_()
    x = torch.randn(8, 1024, device=dev, generator=g)
    before = sum(launches().values())
    try:
        y = linear_apply({"L": L, "R": f["R"]}, x, backend="pallas")
        torch.autograd.grad(y.sum(), [L])
        refused, message = False, ""
    except RuntimeError as e:
        refused, message = True, str(e)
    line = {"phase": "train_refusal", "refused": refused,
            "message": message, "launches": sum(launches().values())
            - before, "card": card}
    emit(line)
    require(refused and "no backward pass" in message
            and line["launches"] == 0,
            "a pallas-backend Monarch layer under autograd did not refuse")
    return line


def _phase_train(dev) -> dict:
    """Phase 3i: training on the card.  (a) card vs CPU at 2 layers for
    gpt2-medium (Monarch), granite-moe-1b-a400m (MoE) and mamba2-2.7b
    (SSD): the card's steps first, the CPU's on a worker thread while the
    card trains (b) gpt2-medium at full width and depth with its resumed
    run; then the step's readings, with the CPU idle again, and (c) the
    kernels' refusal of autograd.  The einsum backend: no kernel launches
    in the phase.  Returns the step's readings and the batch they took
    (phase 6 holds the dry run to them)."""
    import concurrent.futures

    import torch

    from repro_torch import tree_to
    from repro_torch.kernels import launches, reset_launches

    card = _card_line()
    reset_launches()
    pending = []
    with concurrent.futures.ThreadPoolExecutor(1) as cpu:
        for arch in TRAIN_PARITY_ARCHS:
            c, batch, p_gpu = _train_parity_setup(arch, dev)
            on_card = _train_parity_side(c, p_gpu, batch)
            pending.append((arch, c, on_card, cpu.submit(
                _train_parity_side, c, tree_to(p_gpu, "cpu"), batch)))
            del p_gpu
            torch.cuda.empty_cache()
        batches = _train_gpt2(dev, card)
        for arch, c, on_card, on_cpu in pending:
            _train_parity(arch, c, on_card, on_cpu.result(), card)
    readings = _train_readings(_train_gpt2_cfg(), batches[0], dev, card)
    torch.cuda.empty_cache()
    _train_refusal(dev, card)
    counts = {k: v for k, v in launches().items() if v}
    emit({"phase": "train_launches", "launches": counts, "card": card})
    require(not counts, f"phase 3i launched kernels: {counts}")
    return {"readings": readings, "batch": batches[0]}


# -- phase 3j: training under the ("data", "model") mesh --------------------

TM_DATA, TM_MODEL = 2, 2           # four gloo ranks sharing cuda:0
TM_SEQ, TM_BATCH = 1024, 8         # phase 3i's global batch, 8 x 1024
TM_HELD_STEPS, TM_BF16_STEPS = 3, 3
# AdamW with clipping active (a step's norm is above 1 at these inits);
# eps 1e-4 keeps each element's step a smooth function of its gradient,
# where the default's g / (|g| + 1e-8) turns a gradient within rounding
# of 0 into a whole lr (tests/test_torch_train_mesh.py)
TM_OPT = dict(lr=1e-3, clip_norm=1.0, eps=1e-4)
TM_GRANITE_LAYERS = 2
TM_CKPT_STEPS, TM_CKPT_AT = 4, 2
TM_DIR = ROOT / "build" / "train_mesh_ckpt"
# tests/test_torch_train.py's limits for a stepped state
TM_STATE_TOL = dict(rtol=2e-4, atol=2e-5)
TM_NU_TOL = dict(rtol=2e-4, atol=1e-9)


def _tm_cfgs() -> dict:
    """Phase 3j's configs: gpt2-medium as published (24 layers, d 1024,
    the paper's Monarch projections, remat "full") in fp32 and in its
    bf16 compute, granite-moe-1b-a400m at full width cut to
    TM_GRANITE_LAYERS, fp32."""
    from repro_torch.configs import get_config

    gpt2 = _train_gpt2_cfg()
    return {"gpt2_fp32": dataclasses.replace(gpt2, dtype="float32"),
            "gpt2_bf16": gpt2,
            "granite_fp32": dataclasses.replace(
                get_config("granite-moe-1b-a400m"),
                n_layers=TM_GRANITE_LAYERS, dtype="float32")}


def _tm_batches(cfg, n: int, seed: int) -> list:
    from repro_torch.data import DataConfig, make_batches

    it = make_batches(DataConfig(vocab=cfg.vocab, seq_len=TM_SEQ,
                                 global_batch=TM_BATCH, seed=seed),
                      prefetch=0)
    return [next(it) for _ in range(n)]


def _tm_host_batches(cfg, data: int, skip: int = 0):
    """The global batches a Trainer's ``data`` data ranks read together
    (each its host's stream, ``Trainer.host_data``), from the ``skip``-th."""
    import numpy as np

    from repro_torch.data import DataConfig, make_batches

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TM_SEQ,
                      global_batch=TM_BATCH, seed=13)
    hosts = [make_batches(dataclasses.replace(dcfg, host_count=data,
                                              host_index=d), prefetch=0)
             for d in range(data)]
    for _ in range(skip):
        for h in hosts:
            next(h)
    while True:
        parts = [next(h) for h in hosts]
        yield {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _tm_fingerprint(tree) -> dict:
    """{path: (float64 sum, float64 sum of squares)} of a tree's leaves on
    the host: equal trees give equal prints."""
    from repro_torch.optim.adamw import leaves_with_paths

    out = {}
    for path, t in leaves_with_paths(tree):
        t = t.detach().double().cpu()
        out["/".join(path)] = (float(t.sum()), float((t * t).sum()))
    return out


def _tm_host(tree) -> dict:
    from repro_torch import tree_map

    return tree_map(lambda t: t.detach().float().cpu(), tree)


def _tm_held(mesh, dev, cfg, batches) -> dict:
    """A held run on one side: TM_HELD_STEPS AdamW steps: metrics, the
    stepped state, on the host; the first step's loss, its gradients
    read from its first moment (one step from zeros leaves ``mu = (1 -
    b1) g`` of the clipped gradient, the clip's scale one number on
    either side) and an MoE model's routes recorded in it.  Under ``mesh``
    the state is drawn as this rank's shards and the batches cut to its
    rows."""
    import torch

    from repro_torch.launch import steps as S
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import leaves_with_paths

    init, step = S.make_train_step(cfg, adamw(**TM_OPT), mesh=mesh)
    state = init(0, device=dev)
    init_print = _tm_fingerprint(state["params"])
    # one process: its whole first draw, for the ranks' shards to match
    init_whole = None if mesh is not None else {
        "/".join(p): t.detach().cpu()
        for p, t in leaves_with_paths(state["params"])}
    metrics, walls, routes = [], [], []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as ctx:
            if cfg.moe and i == 0:
                ctx.enter_context(_recording_routes(routes))
            state, m = step(state, b if mesh is None
                            else S.shard_batch(b, mesh))
            metrics.append({k: float(v) for k, v in m.items()})
        walls.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            grads = _tm_host(state["opt"].mu)
    return {"loss": metrics[0]["loss"], "lb_loss": metrics[0]["lb_loss"],
            "grads": grads, "routes": routes, "metrics": metrics,
            "step_wall_ms": walls, "init_print": init_print,
            "init_whole": init_whole,
            "params": _tm_host(state["params"]),
            "mu": _tm_host(state["opt"].mu), "nu": _tm_host(state["opt"].nu)}


def _tm_reading(mesh, dev, cfg, batches) -> dict:
    """gpt2-medium in bf16 under the mesh, a reading: each step's loss,
    wall ms (synchronized) and collectives (by kind, and by kind, axis
    and operand bytes); the last step's device ms from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps as S
    from repro_torch.optim import adamw
    from repro_torch.sharding import api

    init, step = S.make_train_step(cfg, adamw(**TM_OPT), mesh=mesh)
    state = init(0, device=dev)
    out = {"loss": [], "step_wall_ms": [], "collectives": [],
           "collective_bytes": []}
    for i, b in enumerate(batches):
        last = i == len(batches) - 1
        api.reset_collectives()
        api.reset_collective_bytes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (profile(activities=[ProfilerActivity.CUDA]) if last
              else contextlib.nullcontext()) as prof:
            state, m = step(state, S.shard_batch(b, mesh))
            out["loss"].append(float(m["loss"]))
            torch.cuda.synchronize()
        out["step_wall_ms"].append((time.perf_counter() - t0) * 1e3)
        out["collectives"].append(api.collectives())
        out["collective_bytes"].append(api.collective_bytes())
    out["last_step_device_ms"] = sum(
        (getattr(e, "self_device_time_total", None) or e.self_cuda_time_total)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA) / 1e3
    return out


def _tm_state_leaves(state) -> list:
    from repro_torch.optim.adamw import leaves_with_paths

    opt = state["opt"]
    return [opt.step] + [t for tree in (state["params"], opt.mu, opt.nu)
                         for _, t in leaves_with_paths(tree)]


def _tm_trainer(mesh, dev, cfg, ckpt_dir: str, steps: int,
                skip: int = 0) -> dict:
    """A Trainer over the data ranks' host streams (one process: their
    concatenation), checkpointing every TM_CKPT_AT steps: its (step, loss)
    pairs; under ``mesh`` also whether this rank's shards restored from
    the last checkpoint are torch.equal to the state it saved."""
    import torch

    from repro_torch.data import DataConfig, make_batches
    from repro_torch.train import Trainer, TrainerConfig

    tcfg = TrainerConfig(steps=steps, peak_lr=1e-3, warmup=1, log_every=0,
                         ckpt_every=TM_CKPT_AT, ckpt_dir=ckpt_dir,
                         keep_last=2)
    trainer = Trainer(cfg, tcfg, mesh=mesh, device=None if mesh else dev)
    if mesh is None:
        batches = _tm_host_batches(cfg, TM_DATA, skip)
    else:
        batches = make_batches(trainer.host_data(DataConfig(
            vocab=cfg.vocab, seq_len=TM_SEQ, global_batch=TM_BATCH,
            seed=13)), prefetch=0)
    state = trainer.run(batches)
    out = {"losses": [(h["step"], h["loss"]) for h in trainer.history]}
    if mesh is not None:
        restored, at = trainer.resume_or_init()
        out["restored_equal"] = at == steps and all(
            torch.equal(a, b) for a, b in zip(_tm_state_leaves(state),
                                              _tm_state_leaves(restored)))
    return out


def _tm_rank(mesh, jobs: dict) -> dict:
    """One rank of phase 3j, each job with this process's peak memory
    while it ran and the kernel launches it made (none: the einsum
    backend)."""
    import torch

    from repro_torch.kernels import launches, reset_launches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    out = {}
    for name, job in jobs.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.perf_counter()
        if job["kind"] == "held":
            res = _tm_held(mesh, dev, job["cfg"], job["batches"])
        elif job["kind"] == "reading":
            res = _tm_reading(mesh, dev, job["cfg"], job["batches"])
        else:
            res = _tm_trainer(mesh, dev, job["cfg"], job["ckpt_dir"],
                              job["steps"])
        res.update(seconds=time.perf_counter() - t0,
                   max_memory_allocated=torch.cuda.max_memory_allocated(dev),
                   launches=sum(launches().values()))
        out[name] = res
    return out


def _tm_dry(cfg, batch):
    """The dry run of one step of ``cfg`` on rank 0 of a shape-only
    (TM_DATA x TM_MODEL) gloo mesh, on ``batch``'s shapes: its
    ``hlo_analysis.StepCount`` (the traced peak is phase 3j's prediction
    of a rank's; its collectives phase 6's check)."""
    from repro_torch.launch.dryrun import count_train_step
    from repro_torch.launch.mesh import shape_mesh
    from repro_torch.optim import adamw

    return count_train_step(cfg, shape_mesh(TM_DATA, TM_MODEL,
                                            backend="gloo"), batch,
                            adamw(**TM_OPT))


def _records(counts: dict) -> list:
    """A ``sharding.api.collective_bytes()`` table as JSON rows [kind,
    axis, operand bytes, count]."""
    return sorted([*k, n] for k, n in counts.items())


def _tm_held_line(name, cfg, one: dict, ranks: list, card: str) -> dict:
    """A held job's line: the ranks' loss and metrics against the
    single-process step's (PARITY_REL_TOL), every gradient leaf put back
    together within TRAIN_GRAD_TOL of its max |g|, the stepped state at
    TM_STATE_TOL / TM_NU_TOL, each rank's first draw equal to its slices
    of the whole one; an MoE model's routes first."""
    import torch

    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import train_plan
    from repro_torch.optim.adamw import leaves_with_paths
    from repro_torch.sharding.params import shard_leaf, unshard_leaf

    plans = [train_plan(cfg, Mesh(model=TM_MODEL, data=TM_DATA, rank=r,
                                  device="cpu")) for r in range(len(ranks))]
    plan0, table = plans[0]

    def whole(key, path):
        parts = []
        for r in ranks:
            t = r[key]
            for k in path:
                t = t[k]
            parts.append(t)
        return unshard_leaf(parts, table["/".join(path)], plan0)

    line = {"phase": "train_mesh_held", "job": name, "model": cfg.name,
            "layers": cfg.n_layers, "dtype": cfg.dtype, "remat": cfg.remat,
            "mesh": {"data": TM_DATA, "model": TM_MODEL},
            "batch": [TM_BATCH, TM_SEQ], "opt": TM_OPT,
            "loss": {"single": one["loss"],
                     "ranks": [r["loss"] for r in ranks]}}
    if cfg.moe:
        # the model ranks of a data index route alike; the data ranks'
        # groups in order are the whole batch's
        by_data = [ranks[d * TM_MODEL]["routes"] for d in range(TM_DATA)]
        joined = [{"probs": torch.cat([c[i]["probs"] for c in by_data]),
                   "idx": torch.cat([c[i]["idx"] for c in by_data]),
                   "kept": torch.cat([c[i]["kept"] for c in by_data]),
                   "k": by_data[0][i]["k"]}
                  for i in range(len(by_data[0]))]
        line["routes"] = _route_check(joined, one["routes"],
                                      f"train mesh {name}")
        line["lb_loss"] = {"single": one["lb_loss"],
                           "ranks": [r["lb_loss"] for r in ranks]}
    rel = [abs(x - one["loss"]) / abs(one["loss"])
           for x in line["loss"]["ranks"]]
    steps_rel = {k: max(abs(r["metrics"][i][k] - m[k]) / max(abs(m[k]),
                                                              1e-30)
                        for r in ranks for i, m in enumerate(one["metrics"]))
                 for k in one["metrics"][0]}
    worst = ("", 0.0)
    for path, g in leaves_with_paths(one["grads"]):
        e = float((whole("grads", path) - g).abs().max()) / max(
            float(g.abs().max()), 1e-30)
        if e > worst[1]:
            worst = ("/".join(path), e)
    state = {}
    for key, tol in (("params", TM_STATE_TOL), ("mu", TM_STATE_TOL),
                     ("nu", TM_NU_TOL)):
        bad, n = 0, 0
        for path, want in leaves_with_paths(one[key]):
            got = whole(key, path)
            bad += int(((got - want).abs()
                        > tol["atol"] + tol["rtol"] * want.abs()).sum())
            n += want.numel()
        state[key] = {"outside_tol": bad, "elements": n, **tol}
    init_equal = all(
        ranks[r]["init_print"] == {
            p: v for p, v in _tm_fingerprint(
                {p: shard_leaf(one["init_whole"][p], table[p], plans[r][0])
                 for p in table}).items()}
        for r in range(len(ranks)))
    line.update(loss_rel=max(rel), metrics_max_rel=steps_rel,
                grads={"worst_leaf": worst[0], "worst_rel_to_max": worst[1]},
                state=state, init_shards_equal_slices=init_equal,
                single_step_wall_ms=one["step_wall_ms"],
                rank_step_wall_ms=[r["step_wall_ms"] for r in ranks],
                loss_tol=PARITY_REL_TOL, grad_tol=TRAIN_GRAD_TOL, card=card)
    emit(line)
    require(max(rel) <= PARITY_REL_TOL and all(
        v <= PARITY_REL_TOL for v in steps_rel.values()),
        f"train mesh {name}: loss or metrics apart: {line['loss']} "
        f"{steps_rel}")
    require(worst[1] <= TRAIN_GRAD_TOL,
            f"train mesh {name}: gradients apart: {line['grads']}")
    require(all(v["outside_tol"] == 0 for v in state.values()),
            f"train mesh {name}: stepped state apart: {state}")
    require(init_equal, f"train mesh {name}: a rank's drawn shards are not "
            f"its slices of the whole draw")
    return line


def _tm_start(pool, only_bf16: bool = False) -> tuple:
    """Phase 3j's world started in ``pool``: (its jobs, the future of its
    ranks).  The held jobs' global batches, the bf16 reading's, granite's
    Trainer checkpointing into TM_DIR; ``only_bf16``: the reading alone."""
    import shutil

    cfgs = _tm_cfgs()
    shutil.rmtree(TM_DIR, ignore_errors=True)
    jobs = {} if only_bf16 else {
        name: {"kind": "held", "cfg": cfgs[name],
               "batches": _tm_batches(cfgs[name], TM_HELD_STEPS, seed)}
        for name, seed in (("gpt2_fp32", 11), ("granite_fp32", 12))}
    jobs["gpt2_bf16"] = {
        "kind": "reading", "cfg": cfgs["gpt2_bf16"],
        "batches": _tm_batches(cfgs["gpt2_bf16"], TM_BF16_STEPS, 14)}
    if not only_bf16:
        jobs["granite_ckpt"] = {"kind": "trainer",
                                "cfg": cfgs["granite_fp32"],
                                "ckpt_dir": str(TM_DIR / "mesh"),
                                "steps": TM_CKPT_STEPS}
    return jobs, _start_world(pool, _tm_rank, TM_DATA * TM_MODEL, jobs,
                              data=TM_DATA)


def _phase_train_mesh(dev, world=None, only_bf16: bool = False) -> dict:
    """Phase 3j: training under a (data 2 x model 2) mesh, four gloo ranks
    sharing the card.  gpt2-medium at full width and depth in fp32 and
    granite-moe-1b-a400m at full width cut to 2 layers are held to the
    single-process step on the card (run in this process, on the same
    seed-0 draw and global batches); gpt2-medium in bf16 is a reading over
    TM_BF16_STEPS steps; granite's Trainer checkpoints under the mesh,
    every rank's restored shards equal the state it saved, and one process
    resumes it.  Each job's peak is read beside the dry run's traced peak
    of one of its steps (``_tm_dry``).  The einsum backend: no kernel
    launches in the phase.  ``world`` is ``_tm_start``'s, when the world
    was started earlier to run beside other phases; else it starts here
    and runs beside this process's part.  Returns the bf16 reading's ranks
    and its dry run (phase 6 holds the one to the other); ``only_bf16``
    runs that job alone (``--dryrun``)."""
    import concurrent.futures
    import shutil

    import torch

    from repro_torch.kernels import launches, reset_launches

    card = _card_line()
    reset_launches()
    cfgs = _tm_cfgs()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jobs, future = world or _tm_start(pool, only_bf16)
        if only_bf16:
            bf16 = jobs["gpt2_bf16"]
            dry = _tm_dry(bf16["cfg"], bf16["batches"][0])
            ranks, _ = future.result()
            return {"ranks": [r["gpt2_bf16"] for r in ranks], "dry": dry}
        held = ("gpt2_fp32", "granite_fp32")
        t0 = time.perf_counter()
        one = {}
        torch.backends.cuda.matmul.allow_tf32 = False
        for name in held:
            torch.cuda.empty_cache()
            one[name] = _tm_held(None, dev, cfgs[name],
                                 jobs[name]["batches"])
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        dry = {j: _tm_dry(jobs[j]["cfg"], jobs[j]["batches"][0])
               for j in ("gpt2_fp32", "gpt2_bf16", "granite_fp32")}
        dry_s = time.perf_counter() - t1
        ranks, world_s = future.result()
    emit({"phase": "train_mesh_world", "ranks": TM_DATA * TM_MODEL,
          "mesh": {"data": TM_DATA, "model": TM_MODEL}, "backend": "gloo",
          "device": "cuda:0 (shared)", "single_seconds": t1 - t0,
          "world_seconds": world_s,
          "world_beside": "phases 3e-3h" if world else "this phase",
          "job_seconds": {j: [r[j]["seconds"] for r in ranks]
                          for j in jobs},
          "note": "four ranks time-slice one card over gloo, and the "
                  "phases named by world_beside: not data-parallel speeds",
          "max_memory_allocated_gb": {
              j: [r[j]["max_memory_allocated"] / 1e9 for r in ranks]
              for j in jobs},
          "traced_peak_gb": {j: c.peak_bytes / 1e9 for j, c in dry.items()},
          "traced_peak_note": "launch/dryrun.py: one step on meta tensors "
                              "at rank 0 of a shape-only mesh",
          "dry_run_seconds": dry_s, "card": card})
    for name in held:
        _tm_held_line(name, cfgs[name], one[name],
                      [r[name] for r in ranks], card)
    rd = [r["gpt2_bf16"] for r in ranks]
    emit({"phase": "train_mesh_reading", "model": "gpt2-medium",
          "dtype": "bfloat16", "remat": cfgs["gpt2_bf16"].remat,
          "batch": [TM_BATCH, TM_SEQ], "loss": rd[0]["loss"],
          "ranks_same_loss": all(r["loss"] == rd[0]["loss"] for r in rd),
          "step_wall_ms": [r["step_wall_ms"] for r in rd],
          "last_step_device_ms": [r["last_step_device_ms"] for r in rd],
          "collectives_per_step": rd[0]["collectives"][-1],
          "collective_bytes_per_step": _records(
              rd[0]["collective_bytes"][-1]),
          "max_memory_allocated_gb": [
              r["max_memory_allocated"] / 1e9 for r in rd],
          "card": card})
    require(all(r["loss"] == rd[0]["loss"] for r in rd)
            and all(math.isfinite(x) for x in rd[0]["loss"]),
            "train mesh bf16: ranks' losses differ or are not finite")
    # granite's mesh checkpoint at TM_CKPT_AT resumed by one process
    mesh_losses = ranks[0]["granite_ckpt"]["losses"]
    src = TM_DIR / "mesh" / f"step_{TM_CKPT_AT:08d}"
    dst = TM_DIR / "single" / src.name
    shutil.copytree(src, dst)
    again = _tm_trainer(None, dev, cfgs["granite_fp32"], str(dst.parent),
                        TM_CKPT_STEPS, skip=TM_CKPT_AT)["losses"]
    want = mesh_losses[TM_CKPT_AT:]
    diff = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(again, want))
    emit({"phase": "train_mesh_checkpoint", "model": cfgs["granite_fp32"]
          .name, "layers": TM_GRANITE_LAYERS, "saved_at": TM_CKPT_AT,
          "mesh_losses": mesh_losses, "single_resumed": again,
          "max_rel": diff, "tol": PARITY_REL_TOL,
          "ranks_same": all(r["granite_ckpt"]["losses"] == mesh_losses
                            for r in ranks),
          "restored_shards_equal": [r["granite_ckpt"]["restored_equal"]
                                    for r in ranks], "card": card})
    require(all(r["granite_ckpt"]["restored_equal"] for r in ranks),
            "train mesh: a rank's shards restored from its checkpoint are "
            "not the state it saved")
    require([s for s, _ in again] == [s for s, _ in want]
            and diff <= PARITY_REL_TOL,
            f"train mesh: the mesh checkpoint resumed on one process gives "
            f"{again}, the mesh run {want}")
    shutil.rmtree(TM_DIR, ignore_errors=True)
    counts = {k: v for k, v in launches().items() if v}
    rank_launches = {j: [r[j]["launches"] for r in ranks] for j in jobs}
    emit({"phase": "train_mesh_launches", "launches": counts,
          "rank_launches": rank_launches, "card": card})
    require(not counts and not any(any(v) for v in rank_launches.values()),
            f"phase 3j launched kernels: {counts} {rank_launches}")
    return {"ranks": rd, "dry": dry["gpt2_bf16"]}


# -- phase 6: the dry run held to the card ---------------------------------

def _dryrun_train_batch() -> dict:
    """Phase 3i's first batch (``--dryrun`` alone: the same draw)."""
    from repro_torch.data import DataConfig, make_batches

    it = make_batches(DataConfig(**TRAIN_DATA), prefetch=0)
    batch = next(it)
    it.close()
    return batch


def _phase_dryrun(dev, train: dict, mesh_run: dict) -> None:
    """Phase 6: the dry run (``launch/dryrun.py``) against the steps the
    card ran.  (a) 3j's gpt2-medium bf16 step: the dry run's collectives
    at rank 0 of a shape-only data 2 x model 2 gloo mesh (``_tm_dry``) equal
    every rank's count of its last step, by kind, axis, operand bytes and
    number, and its per-kind numbers ``collectives()``'s; (b) 3i's
    single-process gpt2-medium step (8 x 1024, bf16 over fp32 masters)
    under remat "full" and "none": the traced peak on meta within
    DRYRUN_PEAK_TOL of the step_peak_gb 3i read; (c) that step (remat
    "full") counted on the card: its FLOPs equal the meta count's (bytes,
    ops and peak a reading); (d) its roofline terms at the data-sheet
    rates against 3i's device ms (a reading)."""
    import numpy as np
    import torch

    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch.dryrun import count_train_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    card = _card_line()
    # (a) collectives, exact
    dry = mesh_run["dry"]
    kinds = {}
    for (kind, _, _), n in dry.collectives.items():
        kinds[kind.replace("-", "_")] = kinds.get(kind.replace("-", "_"),
                                                  0) + n
    ranks = mesh_run["ranks"]
    same = [r["collective_bytes"][-1] == dry.collectives for r in ranks]
    counts = [r["collectives"][-1] == kinds for r in ranks]
    emit({"phase": "dryrun_collectives", "model": "gpt2-medium",
          "dtype": "bfloat16", "mesh": {"data": TM_DATA, "model": TM_MODEL},
          "backend": "gloo", "dry_run": _records(dry.collectives),
          "dry_run_kinds": kinds,
          "ranks": [_records(r["collective_bytes"][-1]) for r in ranks],
          "equal": same, "kinds_equal": counts,
          "dry_run_peak_gb": dry.peak_bytes / 1e9, "card": card})
    require(all(same) and all(counts), "dry run: 3j's collectives differ "
            "from the dry run's")
    # (b) peaks within DRYRUN_PEAK_TOL
    cfg, batch = _train_gpt2_cfg(), train["batch"]
    opt = adamw(lr=1e-4)          # _train_readings' optimizer
    meta = {}
    for remat in ("full", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        meta[remat] = count_train_step(c, None, batch, opt)
        read = train["readings"][remat]["step_peak_gb"] * 1e9
        traced = meta[remat].peak_bytes
        tol = max(DRYRUN_PEAK_TOL["rel"] * read,
                  DRYRUN_PEAK_TOL["abs_bytes"])
        emit({"phase": "dryrun_peak", "model": cfg.name, "remat": remat,
              "batch": list(batch["tokens"].shape),
              "traced_peak_gb": traced / 1e9, "step_peak_gb": read / 1e9,
              "traced_over_read": traced / read, "tol_gb": tol / 1e9,
              "arguments_gb": meta[remat].argument_bytes / 1e9,
              "card": card})
        require(abs(traced - read) <= tol, f"dry run: remat {remat}'s "
                f"traced peak {traced / 1e9:.3f} GB is not within "
                f"{tol / 1e9:.3f} GB of 3i's {read / 1e9:.3f} GB")
    # (c) the step counted on the card
    init, step = make_train_step(cfg, opt)
    state = init(0, device=dev)
    torch.cuda.synchronize()
    on_card = H.count_step(step, state, batch)
    torch.cuda.synchronize()
    m = meta["full"]
    emit({"phase": "dryrun_card_count", "model": cfg.name, "remat": "full",
          "card": {"flops": on_card.flops, "bytes": on_card.bytes,
                   "ops": on_card.ops, "peak_gb": on_card.peak_bytes / 1e9},
          "meta": {"flops": m.flops, "bytes": m.bytes, "ops": m.ops,
                   "peak_gb": m.peak_bytes / 1e9},
          "flops_equal": on_card.flops == m.flops,
          "bytes_equal": on_card.bytes == m.bytes,
          "ops_equal": on_card.ops == m.ops, "card_name": card})
    require(on_card.flops == m.flops, f"dry run: the card counts "
            f"{on_card.flops} FLOPs in 3i's step, meta {m.flops}")
    del state, on_card
    torch.cuda.empty_cache()
    # (d) the roofline terms against the card's device ms, a reading
    tokens = int(np.prod(batch["tokens"].shape))
    n_emb = 0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model
    terms = H.RooflineTerms(
        hlo_flops=float(m.flops), hlo_bytes=float(m.bytes), coll_bytes=0.0,
        n_chips=1, model_flops=float(6 * (cfg.active_param_count() - n_emb)
                                     * tokens))
    dev_ms = train["readings"]["full"]["step_device_ms"]
    bound_ms = max(terms.t_compute, terms.t_memory) * 1e3
    emit({"phase": "dryrun_roofline", "model": cfg.name, "remat": "full",
          "terms": terms.as_dict(), "rates": {"peak_flops": H.PEAK_FLOPS,
                                              "hbm_bw": H.HBM_BW},
          "step_device_ms": dev_ms, "bound_ms": bound_ms,
          "device_over_bound": dev_ms / bound_ms, "card": card})


def _tp_snapshot(mesh, cfg, params, spec: dict) -> dict:
    """A rank of phase 5's snapshots: the tp = 1 snapshot under
    ``tp1_dir`` restored on this mesh and served to the end (its finished
    requests' tokens, its launches); then the trace served afresh for
    ``steps`` steps and saved under ``tp2_dir`` (rank 0 writes, every rank
    gathers its heads)."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serving import ContinuousBatchingEngine, SamplingParams

    eng = ContinuousBatchingEngine.restore_latest(
        spec["tp1_dir"], cfg, params, mesh=mesh,
        **_nongeometry(spec["engine"]))
    reset_launches()
    restored: dict = {}
    _ft_serve(eng, restored, "the tp=1 snapshot restored on the mesh")
    counts = launches()
    eng = ContinuousBatchingEngine(cfg, params, mesh=mesh, **spec["engine"])
    before: dict = {}
    reqs = _ft_serve(eng, before, "the tp=2 serve to its snapshot",
                     trace=[(p, SamplingParams(max_new_tokens=8))
                            for p in spec["prompts"]], steps=spec["steps"])
    eng.save_snapshot(spec["tp2_dir"])
    return {"restored": restored, "launches": counts, "before": before,
            "req_ids": [r.req_id for r in reqs]}


# -- phase 5e: every family at tp = 2 on the one card ----------------------

@contextlib.contextmanager
def _recording_expert_launches(into: list):
    """Every expert-batched B1/B4 launch's (experts, blocks an expert): the
    ``E`` and ``grid`` of its arguments (``kernels.monarch._launch_args``
    wrapped for the block; a launch's blocks are ``E * grid``)."""
    from repro_torch.kernels import monarch as KM

    args_of = KM._launch_args

    def rec(what, *a, **kw):
        args = args_of(what, *a, **kw)
        if what.endswith("_experts"):
            into.append((int(args[14]), int(args[9])))
        return args

    KM._launch_args = rec
    try:
        yield into
    finally:
        KM._launch_args = args_of


@contextlib.contextmanager
def _counting_collectives(into: dict):
    """Every device collective the block issues (``all_reduce``,
    ``all_gather``: ``sharding/api.py``'s two), counted by name."""
    import torch.distributed as dist

    calls = {name: getattr(dist, name) for name in ("all_reduce",
                                                    "all_gather")}

    def counted(name):
        def call(*a, **kw):
            into[name] = into.get(name, 0) + 1
            return calls[name](*a, **kw)
        return call

    for name in calls:
        setattr(dist, name, counted(name))
    try:
        yield into
    finally:
        for name, fn in calls.items():
            setattr(dist, name, fn)


def _tpf_engine(mesh, dev, spec: dict) -> dict:
    """An MoE job of phase 5e on this rank (``mesh=None``: the tp = 1 run
    on the card): the full params from their seed, the continuous-batching
    engine over ``spec["prompts"]`` with eager steps (the routes are
    recorded; a mesh's steps are eager anyway), every step's logits, the
    routes of every MoE call, the launches and each expert-batched
    launch's experts and blocks."""
    import torch

    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import transformer as T
    from repro_torch.serving import ContinuousBatchingEngine

    cfg = spec["cfg"]
    eng = ContinuousBatchingEngine(
        cfg, T.init_params(cfg, seed=spec["seed"], device=dev), mesh=mesh,
        **({} if mesh else {"device": dev}), **spec["engine"])
    eng.step_graphs = None
    lead = mesh is None or mesh.rank == 0
    logits, routes, experts, coll = [], [], [], {}
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with _recording_routes(routes), _recording_expert_launches(experts), \
            _counting_collectives(coll):
        reqs = _drive(eng, [p.copy() for p in spec["prompts"]], 0,
                      spec["new"], spec["what"], logits)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    eng.kv.check_shards()
    slots = eng.params["decoder"]["layers"]["moe"]["experts"]
    leaf = next(iter(_flat(slots).values()))
    return {"tokens": [list(r.output_tokens) for r in reqs],
            "stats": {k: eng.stats[k] for k in (
                "mixed_steps", "kernel_dispatches", "dense_fallbacks")},
            "launches": launches(), "seconds": dt, "collectives": coll,
            "expert_launches": experts, "local_slots": int(leaf.shape[1]),
            "kv_shard": eng.kv.kv_shard,
            "logits": logits if lead else [],
            "routes": routes if lead else []}


def _tpf_steps(mesh, dev, spec: dict) -> dict:
    """A serving-steps job of phase 5e on this rank (``mesh=None``: the
    tp = 1 run): ``make_prefill_step`` on the prompts (and frames), then
    the prompts token by token through ``make_decode_step`` (with
    ``enc_out`` from ``_encode`` for an encoder-decoder model) and
    ``spec["new"]`` greedy tokens; every decode step's logits, the launches
    of each part, and the first and last Mamba layers' states."""
    import torch

    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.steps import (_compute_cast, make_decode_step,
                                          make_prefill_step)
    from repro_torch.models import transformer as T
    from repro_torch.sharding.params import shard_params, tp_plan

    cfg = spec["cfg"]
    params = T.init_params(cfg, seed=spec["seed"], device=dev)
    plan = None
    if mesh is not None:
        plan = tp_plan(params, cfg, mesh)
        params = shard_params(params, plan)
    B, S, new = spec["batch"], spec["prompt"], spec["new"]
    gen = torch.Generator().manual_seed(spec["seed"] + 1)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen).to(dev)
    batch = {"tokens": toks}
    if cfg.encdec:
        batch["enc_embeds"] = torch.randn(
            (B, spec["frames"], cfg.d_model), generator=gen).to(dev)
    lead = mesh is None or mesh.rank == 0
    out: dict = {"layers": cfg.n_layers}
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    pre = make_prefill_step(cfg, plan)(params, batch)
    enc_out = (T._encode(_compute_cast(params, cfg), batch, cfg, plan=plan)
               if cfg.encdec else None)
    torch.cuda.synchronize()
    out.update(prefill_seconds=time.perf_counter() - t0,
               prefill_launches=_counted())
    step = make_decode_step(cfg, plan)
    cache = T.init_decode_cache(cfg, B, S + new, device=dev, plan=plan)
    logits, tokens, coll = [], [], {}
    reset_launches()
    t0 = time.perf_counter()
    with _counting_collectives(coll):
        for t in range(S):
            lg, _ = step(params, toks[:, t].contiguous(), cache, enc_out)
            logits.append(lg[:, :cfg.vocab].cpu() if lead else None)
        for i in range(new):
            tok = torch.argmax(lg[:, :cfg.vocab], dim=-1).to(torch.int32)
            tokens.append(tok.cpu())
            if i < new - 1:
                lg, _ = step(params, tok, cache, enc_out)
                logits.append(lg[:, :cfg.vocab].cpu() if lead else None)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    states = {}
    for path, leaf in _flat(cache).items():
        if path.endswith(("conv", "ssm")):
            flat = leaf.reshape(-1, *leaf.shape[-4 if path.endswith("ssm")
                                                 else -3:])
            states[path] = torch.stack([flat[0], flat[-1]]).cpu()
    out.update(decode_seconds=dt, decode_steps=S + new - 1,
               collectives=coll,
               launches=launches(), tokens=torch.stack(tokens, 1).tolist(),
               prefill=pre[:, :cfg.vocab].cpu() if lead else None,
               logits=[x for x in logits if x is not None], states=states)
    return out


def _tpf_rank(mesh, jobs: dict) -> dict:
    """One rank of phase 5e (``mesh=None``: the tp = 1 runs on the card),
    each job with the card's peak memory while it ran."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda") if mesh is None else mesh.device
    out = {}
    for job, spec in jobs.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        run = _tpf_engine if spec["kind"] == "engine" else _tpf_steps
        out[job] = run(mesh, dev, spec)
        out[job]["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            dev)
    return out


def _tpf_jobs() -> dict:
    """Phase 5e's jobs: the MoE configs through the engine (granite-moe at
    bf16 and fp32, qwen2-moe at fp32 and with int8 factors and fused
    projections), the Mamba, hybrid and encoder-decoder stacks through
    the serving steps at fp32; every one at full width and depth."""
    from repro_torch.configs import get_config

    jobs = {}
    for name, arch, dtype, opts in (
            ("granite_moe_bf16", "granite-moe-1b-a400m", "bfloat16", {}),
            ("granite_moe_fp32", "granite-moe-1b-a400m", "float32", {}),
            ("qwen2_moe_fp32", "qwen2-moe-a2.7b", "float32", {}),
            ("qwen2_moe_int8_fused", "qwen2-moe-a2.7b", "float32",
             dict(quantize="int8", fuse_projections=True))):
        cfg = dataclasses.replace(_on(get_config(arch)), dtype=dtype)
        jobs[name] = {"kind": "engine", "cfg": cfg, "seed": 3,
                      "engine": {**SERVE_KW, "max_len": 256, **opts},
                      "prompts": _serve_prompts(cfg.vocab, *TPF_PROMPTS),
                      "new": TPF_NEW, "what": f"tp families {name}"}
    for name, arch in (("mamba2_steps", "mamba2-2.7b"),
                       ("zamba2_steps", "zamba2-7b"),
                       ("seamless_steps", "seamless-m4t-large-v2")):
        cfg = dataclasses.replace(_on(get_config(arch)), dtype="float32")
        jobs[name] = {"kind": "steps", "cfg": cfg, "seed": 3,
                      **TPF_STEPS}
    return jobs


def _rel_max(a: list, b: list) -> float:
    require(len(a) == len(b) and all(x.shape == y.shape
                                     for x, y in zip(a, b)),
            "other steps than tp = 1")
    return max(_rel(x, y) for x, y in zip(a, b))


def _tpf_engine_lines(name: str, spec: dict, base: dict,
                      rs: list) -> None:
    """Phase 5e's line of an MoE job: the ranks against the card's tp = 1
    run.  fp32: every route identical (a difference only at a printed
    near tie, as phase 3g holds the card to the CPU), then the tokens and
    every step's logits within PARITY_REL_TOL; bf16: a reading.  Every
    rank: one expert-batched launch a projection a layer a step over its
    n_slots / 2 slots, half the tp = 1 blocks in all, B7 every layer and
    step, no unsharded span launch and no dense fallback."""
    cfg = spec["cfg"]
    toks = rs[0]["tokens"]
    steps = rs[0]["stats"]["mixed_steps"]
    routes = _route_check(rs[0]["routes"], base["routes"],
                          f"tp families {name}") \
        if cfg.dtype == "float32" else None
    flipped = bool(routes and routes["differences"])
    flat = [(a, b) for oa, ob in zip(toks, base["tokens"])
            for a, b in zip(oa, ob)]
    line = {"phase": "tp_families", "job": name, "model": cfg.name,
            "dtype": cfg.dtype, "tp": TP, "layers": cfg.n_layers,
            "cut": None, "engine": {k: v for k, v in spec["engine"].items()
                                    if k in ("quantize",
                                             "fuse_projections")},
            "tokens": toks, "tp1_tokens": base["tokens"],
            "identical_to_tp1": toks == base["tokens"],
            "token_agreement": sum(a == b for a, b in flat)
            / max(len(flat), 1),
            "ranks_identical": all(r["tokens"] == toks for r in rs),
            "stats": rs[0]["stats"], "tp1_stats": base["stats"],
            "route_flip": flipped,
            "routes": None if routes is None else {
                "calls": routes["calls"],
                "max_prob_diff": routes["max_prob_diff"],
                "n_differences": len(routes["differences"]),
                "differences": routes["differences"][:8]},
            "per_rank": [{"local_slots": r["local_slots"],
                          "kv_shard": r["kv_shard"],
                          "seconds": r["seconds"],
                          "collectives_per_step": {
                              k: v / steps for k, v in
                              r["collectives"].items()},
                          "max_memory_allocated": r["max_memory_allocated"],
                          "launches_per_step": {
                              k: v / steps for k, v in r["launches"].items()
                              if v}} for r in rs],
            "tp1_seconds": base["seconds"],
            "tp1_max_memory_allocated": base["max_memory_allocated"]}
    if cfg.dtype == "float32":
        line["max_step_rel_err"] = _rel_max(rs[0]["logits"], base["logits"])
        line["rel_tol"] = PARITY_REL_TOL
    else:
        line["note"] = "bf16: a reading, the all-reduce rounds once in fp32"
    quant = "quantize" in spec["engine"]
    expert_k = "monarch_fused_q_experts" if quant else "monarch_fused_experts"
    n_proj = 2 if spec["engine"].get("fuse_projections") else 3
    E = cfg.moe.n_slots
    blocks1 = sum(e * g for e, g in base["expert_launches"])
    line["expert_blocks"] = {"tp1": blocks1, "per_rank": [
        sum(e * g for e, g in r["expert_launches"]) for r in rs]}
    emit(line)
    require(line["ranks_identical"], f"tp families {name}: the ranks' "
            f"tokens differ")
    for r in rs:
        c = r["launches"]
        require(r["stats"] == rs[0]["stats"], f"tp families {name}: the "
                f"ranks' counters differ")
        require(r["local_slots"] == E // TP and all(
            e == E // TP for e, _ in r["expert_launches"])
            and len(r["expert_launches"]) == c[expert_k]
            and c[expert_k] == n_proj * cfg.n_layers * steps
            and 2 * sum(e * g for e, g in r["expert_launches"]) == blocks1
            and c["paged_attention_span_sharded"] == cfg.n_layers * steps
            and c["paged_attention_span"] == 0
            and r["stats"]["dense_fallbacks"] == 0,
            f"tp families {name}: launches {c} over {steps} steps, expert "
            f"launches {r['expert_launches'][:4]}... (tp = 1 blocks "
            f"{blocks1})")
    if cfg.dtype == "float32":
        require(toks == base["tokens"] or flipped, f"tp families {name}: "
                f"tokens differ from tp = 1 with no route difference")
        require(flipped or line["max_step_rel_err"] <= PARITY_REL_TOL,
                f"tp families {name}: step logits "
                f"{line['max_step_rel_err']} apart")
        require(rs[0]["stats"] == base["stats"] or flipped,
                f"tp families {name}: counters differ from tp = 1")


def _tpf_steps_lines(name: str, spec: dict, base: dict, rs: list) -> None:
    """Phase 5e's line of a serving-steps job: tokens identical to the
    card's tp = 1 run, the prefill's and every decode step's fp32 logits
    within PARITY_REL_TOL, the first and last Mamba layers' states put
    back together within PARITY_REL_TOL; zamba2's in_proj staged (B2, two
    launches a Mamba layer a step) at every tp."""
    import torch

    cfg = spec["cfg"]
    toks = rs[0]["tokens"]
    states = {}
    gn = 0 if cfg.ssm is None else cfg.ssm.n_groups * cfg.ssm.d_state
    for path, want in base["states"].items():
        if path.endswith("conv"):
            got = torch.cat([*(r["states"][path][..., :-2 * gn] for r in rs),
                             rs[0]["states"][path][..., -2 * gn:]], -1)
        else:
            got = torch.cat([r["states"][path] for r in rs], -3)
        states[path] = _rel(got, want)
    steps = rs[0]["decode_steps"]
    line = {"phase": "tp_families", "job": name, "model": cfg.name,
            "dtype": cfg.dtype, "tp": TP, "layers": rs[0]["layers"],
            "cut": None, "batch": spec["batch"], "prompt": spec["prompt"],
            "new": spec["new"], "tokens": toks[:2],
            "identical_to_tp1": toks == base["tokens"],
            "ranks_identical": all(r["tokens"] == toks for r in rs),
            "prefill_rel_err": _rel_max([rs[0]["prefill"]],
                                        [base["prefill"]]),
            "max_step_rel_err": _rel_max(rs[0]["logits"], base["logits"]),
            "states_rel_err": states, "rel_tol": PARITY_REL_TOL,
            "per_rank": [{"prefill_seconds": r["prefill_seconds"],
                          "decode_seconds": r["decode_seconds"],
                          "collectives_per_step": {
                              k: v / steps for k, v in
                              r["collectives"].items()},
                          "max_memory_allocated": r["max_memory_allocated"],
                          "prefill_launches": r["prefill_launches"],
                          "launches_per_step": {
                              k: v / steps for k, v in r["launches"].items()
                              if v}} for r in rs],
            "tp1": {"decode_seconds": base["decode_seconds"],
                    "max_memory_allocated": base["max_memory_allocated"],
                    "launches_per_step": {
                        k: v / steps for k, v in base["launches"].items()
                        if v}}}
    emit(line)
    require(line["ranks_identical"] and toks == base["tokens"],
            f"tp families {name}: tokens differ from tp = 1")
    require(max(line["prefill_rel_err"], line["max_step_rel_err"],
                *states.values(), 0.0) <= PARITY_REL_TOL,
            f"tp families {name}: logits or states apart: {line}")
    for r in rs:
        c = r["launches"]
        require(c["monarch_fused"] + c["bdmm"] > 0
                and c["paged_attention_span"] == 0,
                f"tp families {name}: launches {c}")
        if cfg.layer_kind == "hybrid":
            require(c["bdmm"] >= 2 * cfg.n_layers * steps,
                    f"tp families {name}: in_proj's B2 launches {c}")


def _tpf_start(pool) -> tuple:
    """Phase 5e's world started in ``pool``: (its jobs, the future of its
    ranks)."""
    jobs = _tpf_jobs()
    return jobs, _start_world(pool, _tpf_rank, TP, jobs)


def _phase_tp_families(dev, world=None) -> None:
    """Phase 5e: every family at tp = 2, two gloo ranks sharing the card,
    each job held to its tp = 1 run on the card (made in this process).
    ``world`` is ``_tpf_start``'s, when the world was started earlier to
    run beside other phases; else it starts after the tp = 1 runs."""
    import concurrent.futures

    import torch

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jobs = world[0] if world else _tpf_jobs()
        t0 = time.perf_counter()
        base = _tpf_rank(None, jobs)
        t1 = time.perf_counter()
        torch.cuda.empty_cache()
        future = (world[1] if world
                  else _start_world(pool, _tpf_rank, TP, jobs))
        ranks, world_s = future.result()
    emit({"phase": "tp_families_world", "ranks": TP, "backend": "gloo",
          "device": "cuda:0 (shared)", "tp1_seconds": t1 - t0,
          "world_seconds": world_s,
          "world_beside": "phases 3e-3h" if world else "none",
          "note": "two ranks time-slice one card, and the phases named "
                  "by world_beside: not TP speeds",
          "max_memory_allocated": {job: [r[job]["max_memory_allocated"]
                                         for r in ranks] for job in jobs}})
    for name, spec in jobs.items():
        rs = [r[name] for r in ranks]
        if spec["kind"] == "engine":
            _tpf_engine_lines(name, spec, base[name], rs)
        else:
            _tpf_steps_lines(name, spec, base[name], rs)


def _parity_draws(vocab: int, Bp: int, Sp: int) -> tuple:
    """Phase 4's seed-3 draws, in their order: the parity step's (Bp, Sp)
    tokens, then the three traces that phases 4 and 5 serve.  Made once,
    in phase 3, where phase 5c's world starts."""
    import numpy as np

    prng = np.random.default_rng(3)
    toks = prng.integers(0, vocab, (Bp, Sp)).astype(np.int32)
    prefix = list(prng.integers(0, vocab, 40))
    shared = [np.asarray(prefix + [(17 * i + j) % vocab
                                   for j in range(3 + i % 2)])
              for i in range(4)]
    traces = {
        # (engine options, prompts, add one request every n steps; 0: all
        # at once)
        "plain": (dict(max_slots=4, max_len=128, chunk_size=64),
                  [prng.integers(0, vocab, int(n))
                   for n in (16, 33, 48, 64)], 0),
        # 8 usable pages for 14 pages of demand: preemptions mid-flight
        "preemption": (dict(max_slots=4, max_len=128, chunk_size=16,
                            n_pages=9),
                       [prng.integers(0, vocab, int(n))
                        for n in (16, 33, 48, 64)], 0),
        # a shared 40-token prefix; the repeat of the second prompt and
        # the extension of the first match a committed partial page and
        # fork it copy-on-write
        "prefix_cow": (dict(max_slots=4, max_len=128, chunk_size=16),
                       shared + [shared[1],
                                 np.concatenate([shared[0], [5, 6]])], 3),
    }
    return toks, traces


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    from repro_torch import tree_map, tree_to
    from repro_torch.configs import get_config
    from repro_torch.core.monarch import (init_monarch, make_dims,
                                          monarch_to_dense)
    from repro_torch.core.quant import (dequantize_factor,
                                        dequantize_kv_pages,
                                        dequantize_monarch, kv_page_bytes,
                                        quantize_factor, quantize_kv_page,
                                        quantize_kv_write, quantize_monarch)
    from repro_torch.kernels import build_all, launches, reset_launches
    from repro_torch.kernels import ops
    from repro_torch.kernels.bdmm import (bdmm, bdmm_plain, bdmm_q,
                                          bdmm_q_plain)
    from repro_torch.kernels.monarch import (fused_fits, fused_geometry,
                                             monarch_fused,
                                             monarch_fused_plain,
                                             monarch_fused_q,
                                             monarch_fused_q_plain)
    from repro_torch.kernels import paged as PG
    from repro_torch.kernels.paged import (GLOBAL_WINDOW,
                                           paged_attention_span,
                                           paged_attention_span_plain,
                                           paged_attention_span_sharded,
                                           span_geometry)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.decode_path import (decode_weight_bytes,
                                                prepare_decode_params)
    from repro_torch.models.fuse import fuse_linears
    from repro_torch.serving import ContinuousBatchingEngine, SamplingParams

    # fp32 products in full precision everywhere (PyTorch's default for
    # matmul; stated so no environment can turn TF32 on under the check)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    t_phase = [t_start]

    def phase_done(name: str) -> None:
        """Print the seconds since the last phase ended, and the most this
        process reserved on the card meanwhile (the worlds that run beside
        phases 3-3h must fit beside it)."""
        now = time.perf_counter()
        emit({"phase": "phase_seconds", "name": name,
              "seconds": now - t_phase[0],
              "max_memory_reserved_gb": torch.cuda.max_memory_reserved()
              / 1e9})
        torch.cuda.reset_peak_memory_stats()
        t_phase[0] = now

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    per_source = build_all()
    from repro_torch.kernels import _build
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": per_source, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "ptxas": {n: _ptxas_report(log)
                    for n, log in _build.BUILD_LOG.items()}})
    phase_done("1 build")

    if "--train" in sys.argv[1:]:
        # the training phase alone
        _phase_train(dev)
        emit({"phase": "done", "seconds": time.perf_counter() - t_start,
              "card": _card_line()})
        return 0

    if "--train-mesh" in sys.argv[1:]:
        # phase 3j alone
        _phase_train_mesh(dev)
        emit({"phase": "done", "seconds": time.perf_counter() - t_start,
              "card": _card_line()})
        return 0

    if "--dryrun" in sys.argv[1:]:
        # phase 6 alone, after the steps of 3i and 3j it holds the dry run to
        batch = _dryrun_train_batch()
        readings = _train_readings(_train_gpt2_cfg(), batch, dev,
                                   _card_line())
        torch.cuda.empty_cache()
        mesh_run = _phase_train_mesh(dev, only_bf16=True)
        phase_done("6 3i step readings and 3j bf16 world")
        _phase_dryrun(dev, {"readings": readings, "batch": batch}, mesh_run)
        phase_done("6 dry run")
        emit({"phase": "done", "seconds": time.perf_counter() - t_start,
              "card": _card_line()})
        return 0

    if "--tp-families" in sys.argv[1:]:
        # phase 5e alone
        _phase_tp_families(dev)
        emit({"phase": "done", "seconds": time.perf_counter() - t_start,
              "card": _card_line()})
        return 0

    if "--serves" in sys.argv[1:]:
        # the profiled serves alone: float and quantized (timed serve and
        # windows), then the 128-block serves' windows, as in phase 3
        gpt2 = get_config("gpt2-medium")
        cfg = dataclasses.replace(gpt2, monarch=dataclasses.replace(
            gpt2.monarch, backend="pallas"))
        params = T.init_params(cfg, seed=0, device=dev)
        qopts = dict(quantize="int8", fuse_projections=True, kv_dtype="int8")
        pool_bytes = {}
        for name, kw in (("float", {}), ("quantized", qopts)):
            eng, reqs, counts, dt, out, _ = _serve(cfg, params, 8, 32, 256,
                                                   32, 0, **kw, **pool_bytes)
            pool_bytes = {"pool_bytes": eng.pool_host.stats().pool_bytes}
            emit({"phase": "serves", "serve": name, "seconds": dt,
                  "new_tokens": out, "tokens_per_s": out / dt,
                  "steps": eng.stats["mixed_steps"], "launches": counts,
                  "graphs": _graph_stats(eng)})
            del eng
            emit({"phase": "serves_profile", "serve": name,
                  **_profile_serve(cfg, params, **kw)})
        cfg_st = dataclasses.replace(gpt2, monarch=dataclasses.replace(
            gpt2.monarch, backend="pallas", nblocks=128))
        params = T.init_params(cfg_st, seed=0, device=dev)
        for name, kw in (("staged", {}), ("staged_quantized", qopts)):
            emit({"phase": "serves_profile", "serve": name,
                  **_profile_serve(cfg_st, params, watch=("bdmm",), **kw)})
        emit({"phase": "done", "seconds": time.perf_counter() - t_start})
        return 0

    sleep_cycles_per_ms: list = []

    def hold_card(ms: float) -> None:
        """Keep the card busy for about ``ms`` (``torch.cuda._sleep`` spins
        for a number of clock cycles, calibrated once against CUDA events)."""
        if not sleep_cycles_per_ms:
            torch.cuda._sleep(1000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            torch.cuda._sleep(20_000_000)
            b.record()
            torch.cuda.synchronize()
            sleep_cycles_per_ms.append(20_000_000 / a.elapsed_time(b))
        torch.cuda._sleep(int(ms * sleep_cycles_per_ms[0]))

    def time_ms(fn, iters: int = 20,
                repeats: int = 5) -> tuple[float, float, float]:
        """Median ms per call over ``repeats`` timed loops of ``iters``
        calls, and the spread (max - min) / median of those loops: the
        loops run as fast as the host issues them, so a call shorter than
        its host time reads the host's rate.  Third, the card's own ms per
        call: the median of the same loops issued while the card is held
        busy for longer than the issue takes, so that the calls run back to
        back on the card.  ``iters`` is cut so that a loop takes about
        TIME_LOOP_MS, as the second warm call measured it."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
        if one_ms < TIME_LOOP_MS:
            fn()
        iters = max(1, min(iters, int(TIME_LOOP_MS / max(one_ms, 1e-3))))
        torch.cuda.synchronize()
        runs, card, issue_s = [], [], 0.0
        for held in (False, True):
            for _ in range(repeats):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                if held:
                    hold_card(min(1.5e3 * issue_s, 250.0))
                a.record()
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn()
                issue_s = max(issue_s, time.perf_counter() - t0)
                b.record()
                b.synchronize()
                (card if held else runs).append(a.elapsed_time(b) / iters)
        runs.sort()
        card.sort()
        med = runs[len(runs) // 2]
        return med, (runs[-1] - runs[0]) / med, card[len(card) // 2]

    def timings(**fns) -> dict:
        """``<name>_ms``, ``<name>_spread`` and ``<name>_card_ms`` for each
        function."""
        out = {}
        for name, fn in fns.items():
            (out[f"{name}_ms"], out[f"{name}_spread"],
             out[f"{name}_card_ms"]) = time_ms(fn)
        return out

    def summary_entry(t: dict, bms: float, by: str) -> dict:
        return {"ms": t["kernel_ms"], "spread": t["kernel_spread"],
                "card_ms": t["kernel_card_ms"],
                "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
                "library_card_ms": t["library_card_ms"],
                "bound_ms": bms, "bound_by": by}

    def launch_shape(L_shape, R_shape, x, w_bits) -> dict:
        """The fused Monarch kernel's launch: blocks (``grid``) and what
        each owns (kernels/monarch.py:fused_geometry)."""
        g = fused_geometry(L_shape, R_shape, x.shape[0], x.element_size(),
                           w_bits)
        return {"grid": g.grid, "tile_t": g.tile_t, "q_group": g.q_group,
                "slab": g.slab, "chunk": g.chunk,
                "smem_bytes": g.smem_bytes}

    def close(out, ref, dtype_name: str) -> tuple[float, bool]:
        o, r = out.float(), ref.float()
        tol = TOL[dtype_name]
        err = (o - r).abs()
        ok = bool(torch.isfinite(o).all()) and bool(
            (err <= tol + tol * r.abs()).all())
        return float(err.max()) if err.numel() else 0.0, ok

    errs = {k: 0.0 for k in KERNELS}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def dn_of(dt) -> str:
        return str(dt).split(".")[1]

    # -- 2b0. B2/B5 at their call sets (BDMM_CALL_SETS): both stages of each
    # projection as ops.monarch_mm issues them (stage 2 reads stage 1's
    # output through its transposed view), bf16 x (gemma2's B2 also fp32
    # x), fp32 factors (B2) or int8 / int4 (B5), at T = 8 and 512; each line with both stages'
    # launches (kernels/bdmm.py:bdmm_geometry), two launches torch.equal,
    # and B5 torch.equal to B2 on the dequantized blocks --------------------
    from repro_torch.kernels import bdmm as BD

    # ``--calls`` also times an older checkout, whose bdmm module has no
    # geometry: its lines carry none
    geometry_of = getattr(BD, "bdmm_geometry", None)
    gb = torch.Generator(device=dev)
    gb.manual_seed(16)

    def stage_calls(f: dict, bits: int = 0) -> list:
        """One projection's two stages: for each, its blocks, the bytes of
        its weights, the kernel, its plain version, B2 on the dequantized
        blocks (B5 only) and the library yardstick (one batched bf16
        torch.matmul on the dequantized blocks)."""
        out = []
        for w in ("L", "R"):
            if bits:
                wq, sc = f[w + "q"], f[w + "s"]
                wf = dequantize_factor(wq, sc, unpacked_dim=wq.shape[2] * (
                    2 if bits == 4 else 1))
                call = {"w_bytes": wq.numel() + 4 * sc.numel(),
                        "kernel": lambda x, wq=wq, sc=sc: bdmm_q(x, wq, sc),
                        "plain": lambda x, wq=wq, sc=sc: bdmm_q_plain(
                            x, wq, sc),
                        "twin": lambda x, wf=wf: bdmm(x, wf)}
            else:
                wf = f[w]
                call = {"w_bytes": 4 * wf.numel(),
                        "kernel": lambda x, wf=wf: bdmm(x, wf),
                        "plain": lambda x, wf=wf: bdmm_plain(x, wf)}
            wts = {torch.bfloat16: wf.to(torch.bfloat16).transpose(1, 2),
                   torch.float32: wf.float().transpose(1, 2)}
            out.append({**call, "blocks": tuple(wf.shape),
                        "library": lambda x, wts=wts: torch.matmul(
                            x.transpose(0, 1), wts[x.dtype]).transpose(0, 1)})
        return out

    def run_stages(calls: list, xs: list, which: str) -> list:
        """Every projection's stage 1 on its x, stage 2 on stage 1's
        output through the transposed view; the outputs."""
        outs = []
        for x, (s1, s2) in zip(xs, calls):
            u = s1[which](x.view(x.shape[0], s1["blocks"][0], -1))
            outs += [u, s2[which](u.transpose(1, 2))]
        return outs

    def stage_geometry(T_, blocks, bits, contiguous, x_bytes) -> dict:
        k, q, p = blocks
        g = geometry_of(T_, k, q, p, x_bytes, bits, contiguous)
        return {"blocks": [k, q, p], **g._asdict()}

    def bdmm_call_set(name: str, T_: int, bits: int, fs: list,
                      x_dtype=torch.bfloat16) -> dict:
        """One kernel line: the call set's stages at T_ tokens, x in
        ``x_dtype``; bits 32: B2 on fs, else B5 on fs quantized to
        ``bits``."""
        calls = [stage_calls(quantize_monarch(f, bits), bits) if bits < 32
                 else stage_calls(f) for f in fs]
        xs = [torch.randn(T_, f["L"].shape[0] * f["L"].shape[2],
                          generator=gb, device=dev).to(x_dtype)
              for f in fs]
        xn, xb = dn_of(x_dtype), x_dtype.itemsize
        err, ok, again, same = 0.0, True, True, True
        n_bytes = flops = 0
        geos = {}
        for x, (s1, s2) in zip(xs, calls):
            x3 = x.view(T_, s1["blocks"][0], -1)
            u = s1["kernel"](x3)
            ut = u.transpose(1, 2)
            y = s2["kernel"](ut)
            for s_, xin, out in ((s1, x3, u), (s2, ut, y)):
                e, o = close(out, s_["plain"](xin), xn)
                err, ok = max(err, e), ok and o
                again = again and torch.equal(out, s_["kernel"](xin))
                if "twin" in s_:
                    same = same and torch.equal(out, s_["twin"](xin))
                k, q, p = s_["blocks"]
                n_bytes += xb * T_ * k * (p + q) + s_["w_bytes"]
                flops += 2 * T_ * k * q * p
                if geometry_of is not None:
                    geos.setdefault(f"{k}x{q}x{p}", stage_geometry(
                        T_, s_["blocks"], bits, xin.stride(2) == 1, xb))
        # decode sums with fp32 FMA; prefill with TF32 tensor cores, two
        # products a multiply-add (bf16 x has no small half), three for
        # fp32 x (3xTF32)
        tc = T_ > 16
        passes = 2 if x_dtype == torch.bfloat16 else 3
        peak = TF32_FLOPS_PER_S / passes if tc else FP32_FLOPS_PER_S
        bms, by = bound_ms(n_bytes, flops, False, peak)
        kind = "bdmm" if bits == 32 else "bdmm_q"
        line = {"phase": "kernel", "kernel": kind, "call_set": name,
                "T": T_, "x_dtype": xn,
                "weights": {32: "float32", 8: "int8", 4: "int4"}[bits],
                "launches": 2 * len(fs), "max_abs_err": err,
                "tol": TOL[xn], "deterministic": again,
                **({"bitwise_vs_bdmm": same} if bits < 32 else {}),
                "launch": geos or None,
                **timings(kernel=lambda: run_stages(calls, xs, "kernel"),
                          plain=lambda: run_stages(calls, xs, "plain"),
                          library=lambda: run_stages(calls, xs, "library")),
                "bound_ms": bms, "bound_by": by,
                "bound_rate": f"tf32 tensor cores / {passes} products" if tc
                else "fp32 fma"}
        emit(line)
        errs[kind] = max(errs[kind], err)
        require(ok and again and same,
                f"{kind} {name} T={T_} int{bits} x {xn}: err {err}, "
                f"deterministic "
                f"{again}, bitwise {same}")
        return line

    bdmm_lines: dict = {}
    bdmm_sets: dict = {}
    families_only = "--families" in sys.argv[1:]
    for name, (proj, nblocks, fused) in (
            {} if families_only else BDMM_CALL_SETS).items():
        fs = [init_monarch(gb, make_dims(din, dout, policy="paper",
                                         nblocks=nblocks), device=dev)
              for din, dout in proj]
        # B5 on the quantized decode path's projections: QKV or w1g fused
        fq = [fuse_linears(fs[:fused])] + fs[fused:] if fused else fs
        require(not any(fused_fits(f["L"].shape, f["R"].shape)
                        for f in fs + fq),
                f"{name} must take the staged branch")
        bdmm_sets[name] = (fs, fq)
        for T_ in (8, 512):
            for bits in (32, 8, 4):
                bdmm_lines[name, T_, bits] = bdmm_call_set(
                    name, T_, bits, fs if bits == 32 else fq)
            if name.startswith(("f_gemma2", "g_gemma2")):
                # and fp32 x, as phase 3g's card-vs-CPU steps run B2
                bdmm_call_set(name, T_, 32, fs, torch.float32)
    if "--calls" in sys.argv[1:]:
        # and the 128-block serves' profiled windows, as in phase 3
        cfg_st = dataclasses.replace(get_config("gpt2-medium"),
                                     monarch=dataclasses.replace(
                                         get_config("gpt2-medium").monarch,
                                         backend="pallas", nblocks=128))
        params = T.init_params(cfg_st, seed=0, device=dev)
        qopts = dict(quantize="int8", fuse_projections=True, kv_dtype="int8")
        emit({"phase": "serve_profile_staged",
              **_profile_serve(cfg_st, params, watch=("bdmm",))})
        emit({"phase": "serve_profile_staged_quantized", "options": qopts,
              **_profile_serve(cfg_st, params, watch=("bdmm",), **qopts)})
        emit({"phase": "done", "seconds": time.perf_counter() - t_start})
        return 0

    # -- 2n. B1 and B2 at the shapes phase 3h's configs give them: odd
    # block widths (mamba2's in_proj, s 661: B1; zamba2's, s 911: B2),
    # blocks that are no power of two (the out_proj pairs at k = q = 80 and
    # 112: B1; zamba2's w2 at p 112: B2), internvl2's staged pairs (128
    # blocks: wq; w2 at k 224, q 256), each against its plain version at T
    # = 8 and 512, bf16 and fp32 x (B1 also bf16 x on bf16 factors, as the
    # Mamba serves' cast steps run it) ----------------------------------------
    for name, (din, dout) in FAMILY_FUSED.items():
        dims = make_dims(din, dout, policy="paper")
        require(fused_fits(dims.l_shape, dims.r_shape),
                f"{name} must take the fused branch")
        f32 = init_monarch(gb, dims, device=dev)
        for fdt in (torch.float32, torch.bfloat16):
            L, R = f32["L"].to(fdt), f32["R"].to(fdt)
            n_par = L.numel() + R.numel()
            W = monarch_to_dense(f32["L"], f32["R"])
            for T_ in (8, 512):
                for xdt in ((torch.float32, torch.bfloat16)
                            if fdt == torch.float32 else (torch.bfloat16,)):
                    dn = dn_of(xdt)
                    x = randn(T_, din, dtype=xdt)
                    err, ok = close(monarch_fused(x, L, R),
                                    monarch_fused_plain(x, L, R), dn)
                    errs["monarch_fused"] = max(errs["monarch_fused"], err)
                    Wx = W.to(xdt)
                    bms, by = bound_ms(T_ * (din + dout) * x.element_size()
                                       + n_par * L.element_size(),
                                       2 * T_ * n_par,
                                       all_bf16=fdt == xdt == torch.bfloat16)
                    emit({"phase": "kernel", "kernel": "monarch_fused",
                          "shape": name, "dims": [din, dout],
                          "blocks": [dims.k, dims.q, dims.p, dims.s],
                          "T": T_, "x_dtype": dn, "factor_dtype": dn_of(fdt),
                          "max_abs_err": err, "tol": TOL[dn],
                          **launch_shape(L.shape, R.shape, x,
                                         16 if fdt == torch.bfloat16 else 32),
                          **timings(kernel=lambda: monarch_fused(x, L, R),
                                    plain=lambda: monarch_fused_plain(
                                        x, L, R),
                                    library=lambda: torch.matmul(x, Wx)),
                          "bound_ms": bms, "bound_by": by})
                    require(ok, f"monarch_fused {name} T={T_} x {dn} "
                            f"factors {dn_of(fdt)}: err {err}")
    for name, proj in FAMILY_STAGED.items():
        fs = [init_monarch(gb, make_dims(din, dout, policy="paper"),
                           device=dev) for din, dout in proj]
        require(not any(fused_fits(f["L"].shape, f["R"].shape) for f in fs),
                f"{name} must take the staged branch")
        for T_ in (8, 512):
            for xdt in (torch.bfloat16, torch.float32):
                bdmm_call_set(name, T_, 32, fs, xdt)
    if families_only:
        # the four configs' phase alone, after their call sets
        _phase_families(dev)
        emit({"phase": "done", "seconds": time.perf_counter() - t_start,
              "card": _card_line()})
        return 0

    # -- 2a. monarch_fused at gpt2-medium's three Monarch shapes -------------
    gpt2 = get_config("gpt2-medium")
    layer_shapes = {"attn_1024x1024": (1024, 1024),
                    "w1_1024x4096": (1024, 4096),
                    "w2_4096x1024": (4096, 1024)}
    factors = {}
    for name, (din, dout) in layer_shapes.items():
        dims = make_dims(din, dout, policy=gpt2.monarch.policy)
        factors[name] = init_monarch(gen, dims, device=dev)
        require(fused_fits(dims.l_shape, dims.r_shape),
                f"gpt2-medium {name} must take the fused branch")
    for name, (din, dout) in layer_shapes.items():
        L, R = factors[name]["L"], factors[name]["R"]
        params = L.numel() + R.numel()
        for T_ in (1, 8, 64, 512):
            for xdt in (torch.float32, torch.bfloat16):
                dn = dn_of(xdt)
                x = randn(T_, din, dtype=xdt)
                err, ok = close(monarch_fused(x, L, R),
                                monarch_fused_plain(x, L, R), dn)
                torch.cuda.synchronize()
                errs["monarch_fused"] = max(errs["monarch_fused"], err)
                W = monarch_to_dense(L, R).to(xdt)
                xb = x.element_size()
                bms, by = bound_ms(T_ * (din + dout) * xb + params * 4,
                                   2 * T_ * params, all_bf16=False)
                emit({"phase": "kernel", "kernel": "monarch_fused",
                      "shape": name, "T": T_, "x_dtype": dn,
                      "factor_dtype": "float32", "max_abs_err": err,
                      "tol": TOL[dn], **launch_shape(L.shape, R.shape, x, 32),
                      **timings(kernel=lambda: monarch_fused(x, L, R),
                                plain=lambda: monarch_fused_plain(x, L, R),
                                library=lambda: torch.matmul(x, W)),
                      "bound_ms": bms, "bound_by": by})
                require(ok, f"monarch_fused {name} T={T_} {dn}: err {err}")

    # -- 2b. bdmm directly and through the staged monarch_mm branch ----------
    sd = make_dims(4096, 4096, nblocks=128)
    require(not fused_fits(sd.l_shape, sd.r_shape),
            "make_dims(4096, 4096, nblocks=128) must exceed the fused fit")
    sf = init_monarch(gen, sd, device=dev)
    for T_ in (8, 512):
        for xdt in (torch.float32, torch.bfloat16):
            dn = dn_of(xdt)
            x3 = randn(T_, sd.k, sd.p, dtype=xdt)
            w = sf["L"]
            out = bdmm(x3, w)
            err, ok = close(out, bdmm_plain(x3, w), dn)
            again = torch.equal(out, bdmm(x3, w))
            errs["bdmm"] = max(errs["bdmm"], err)
            xt = x3.transpose(0, 1)
            wt = w.to(xdt).transpose(1, 2)
            bms, by = bound_ms(
                T_ * sd.k * (sd.p + sd.q) * x3.element_size() + w.numel() * 4,
                2 * T_ * w.numel(), all_bf16=False)
            emit({"phase": "kernel", "kernel": "bdmm", "shape": "direct",
                  "x": [T_, sd.k, sd.p], "w": list(w.shape), "x_dtype": dn,
                  "max_abs_err": err, "tol": TOL[dn], "deterministic": again,
                  **timings(kernel=lambda: bdmm(x3, w),
                            plain=lambda: bdmm_plain(x3, w),
                            library=lambda: torch.matmul(xt, wt)),
                  "bound_ms": bms, "bound_by": by})
            require(ok and again, f"bdmm direct T={T_} {dn}: err {err}, "
                    f"deterministic {again}")
            x = randn(T_, sd.din, dtype=xdt)
            before = launches()
            y = ops.monarch_mm(x, sf["L"], sf["R"])
            after = launches()
            require(after["bdmm"] - before["bdmm"] == 2
                    and after["monarch_fused"] == before["monarch_fused"],
                    "staged monarch_mm must launch bdmm twice")
            err, ok = close(y, monarch_fused_plain(x, sf["L"], sf["R"]), dn)
            errs["bdmm"] = max(errs["bdmm"], err)
            emit({"phase": "kernel", "kernel": "bdmm",
                  "shape": "staged monarch_mm 4096x4096 nblocks=128", "T": T_,
                  "x_dtype": dn, "max_abs_err": err, "tol": TOL[dn]})
            require(ok, f"staged monarch_mm T={T_} {dn}: err {err}")

    # -- 2c. paged_attention_span -------------------------------------------
    B, H, KV, hd, pg, max_len = 8, 16, 16, 64, 16, 1024
    MP = max_len // pg
    P = 1 + B * MP
    prng = np.random.default_rng(0)
    pt = torch.from_numpy(prng.permutation(np.arange(1, P)).reshape(B, MP)
                          .astype(np.int32)).to(dev)
    k32, v32 = randn(P, pg, KV, hd), randn(P, pg, KV, hd)
    cases = {
        "decode": (1, [0, 15, 16, 100, 511, 700, 1000, 1023],
                   [1] * 8),
        "prefill": (64, [0, 64, 128, 300, 500, 900, 960, 0],
                    [64, 64, 30, 64, 1, 64, 64, 0]),
        # a span of 8 query tiles; valid rows end inside and at tile edges
        "prefill512": (512, [0, 512, 100, 0, 300, 500, 0, 700],
                       [512, 512, 200, 65, 1, 300, 0, 128]),
    }

    def span_work(starts, spans, win) -> tuple[int, int]:
        """Pages and attended (query, key) pairs this data needs."""
        n_pages, n_pairs = 0, 0
        for b in range(B):
            if spans[b] == 0:
                continue
            lo = max(0, starts[b] - win + 1)
            hi = starts[b] + spans[b] - 1
            n_pages += min(hi // pg, MP - 1) - lo // pg + 1
            for i in range(spans[b]):
                qp = starts[b] + i
                n_pairs += qp - max(0, qp - win + 1) + 1
        return n_pages, n_pairs

    def span_launch(S, heads) -> dict:
        """The span kernel's launch for B rows of ``heads`` query heads
        (kernels/paged.py:span_geometry; blocks over the whole grid)."""
        g = span_geometry(S, hd, pg, MP)
        return {"tile": g.tile, "pps": g.pps, "splits": g.n_splits,
                "blocks": B * heads * g.blocks, "stages": g.stages}

    def sdpa_args(q, kp, vp, st, S, win):
        """Library yardstick: SDPA over pre-gathered contiguous KV."""
        T_all, kvh = MP * pg, kp.shape[2]
        kk = kp[pt.long()].reshape(B, T_all, kvh, hd).transpose(1, 2)
        vv = vp[pt.long()].reshape(B, T_all, kvh, hd).transpose(1, 2)
        t = torch.arange(T_all, device=dev)[None, None, :]
        qpos = st.long()[:, None] + torch.arange(S, device=dev)[None]
        mask = ((t <= qpos[..., None]) & (qpos[..., None] - t < win))[:, None]
        return q.transpose(1, 2), kk, vv, mask

    paged_summary = None
    for cname, (S, starts, spans) in cases.items():
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        sl = torch.tensor(spans, dtype=torch.int32, device=dev)
        for win in (GLOBAL_WINDOW, 48):
            for dt in (torch.float32, torch.bfloat16):
                dn = dn_of(dt)
                q = randn(B, S, H, hd, dtype=dt)
                kp, vp = k32.to(dt), v32.to(dt)
                args = (q, kp, vp, pt, st, sl, win)
                out = paged_attention_span(*args)
                err, ok = close(out, paged_attention_span_plain(*args), dn)
                again = torch.equal(out, paged_attention_span(*args))
                errs["paged_attention_span"] = max(
                    errs["paged_attention_span"], err)
                n_pages, n_pairs = span_work(starts, spans, win)
                eb = q.element_size()
                bms, by = bound_ms(
                    2 * B * S * H * hd * eb + 2 * n_pages * pg * KV * hd * eb,
                    4 * hd * H * n_pairs, all_bf16=dt == torch.bfloat16)
                qq, kk, vv, mask = sdpa_args(q, kp, vp, st, S, win)
                line = {
                    "phase": "kernel", "kernel": "paged_attention_span",
                    "case": cname, "S": S, "window": win, "dtype": dn,
                    "B": B, "H": H, "KV": KV, "hd": hd, "page": pg,
                    "pages_read": n_pages, "max_abs_err": err,
                    "tol": TOL[dn], "launch": span_launch(S, H),
                    "deterministic": again,
                    **timings(
                        kernel=lambda: paged_attention_span(*args),
                        plain=lambda: paged_attention_span_plain(*args),
                        library=lambda: F.scaled_dot_product_attention(
                            qq, kk, vv, attn_mask=mask)),
                    "bound_ms": bms, "bound_by": by}
                emit(line)
                require(ok and again, f"paged {cname} window={win} {dn}: "
                        f"err {err}, deterministic {again}")
                if (cname == "decode" and win == GLOBAL_WINDOW
                        and dt == torch.bfloat16):
                    paged_summary = line

    # -- 2d. the remaining dtype templates: bf16 factors and weights, and
    # queries in the other width than their pages ----------------------------
    f32, bf16 = torch.float32, torch.bfloat16
    for name, (din, dout) in layer_shapes.items():
        Lb, Rb = (factors[name][k].to(bf16) for k in ("L", "R"))
        for xdt in (f32, bf16):
            dn = dn_of(xdt)
            x = randn(8, din, dtype=xdt)
            err, ok = close(monarch_fused(x, Lb, Rb),
                            monarch_fused_plain(x, Lb, Rb), dn)
            errs["monarch_fused"] = max(errs["monarch_fused"], err)
            emit({"phase": "kernel_dtypes", "kernel": "monarch_fused",
                  "shape": name, "T": 8, "x_dtype": dn,
                  "factor_dtype": "bfloat16", "max_abs_err": err,
                  "tol": TOL[dn], **launch_shape(Lb.shape, Rb.shape, x, 16)})
            require(ok, f"monarch_fused bf16 factors {name} {dn}: {err}")
    wb = sf["L"].to(bf16)
    for xdt in (f32, bf16):
        dn = dn_of(xdt)
        x3 = randn(64, sd.k, sd.p, dtype=xdt)
        err, ok = close(bdmm(x3, wb), bdmm_plain(x3, wb), dn)
        errs["bdmm"] = max(errs["bdmm"], err)
        emit({"phase": "kernel_dtypes", "kernel": "bdmm", "T": 64,
              "x_dtype": dn, "w_dtype": "bfloat16", "max_abs_err": err,
              "tol": TOL[dn]})
        require(ok, f"bdmm bf16 weights {dn}: {err}")
    S, starts, spans = cases["prefill"]
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    sl = torch.tensor(spans, dtype=torch.int32, device=dev)
    for qdt, kdt in ((f32, bf16), (bf16, f32)):
        dn = dn_of(qdt)
        args = (randn(B, S, H, hd, dtype=qdt), k32.to(kdt), v32.to(kdt), pt,
                st, sl, 48)
        err, ok = close(paged_attention_span(*args),
                        paged_attention_span_plain(*args), dn)
        errs["paged_attention_span"] = max(errs["paged_attention_span"], err)
        emit({"phase": "kernel_dtypes", "kernel": "paged_attention_span",
              "S": S, "window": 48, "q_dtype": dn,
              "page_dtype": dn_of(kdt), "max_abs_err": err,
              "tol": TOL[dn]})
        require(ok, f"paged q {dn} pages {kdt}: {err}")

    # -- 2e. monarch_fused_q: int8/int4 factors at gpt2-medium's shapes, the
    # fused QKV projection included -------------------------------------------
    qkv = fuse_linears([init_monarch(gen, make_dims(1024, 1024), device=dev)
                        for _ in range(3)])
    require(tuple(qkv["L"].shape) == (32, 96, 32)
            and tuple(qkv["R"].shape) == (96, 32, 32),
            "the fused QKV pair is L (32, 96, 32), R (96, 32, 32)")
    qfactors = {"qkv_1024x3072": qkv, **factors}
    for name, f in qfactors.items():
        k, q_, p = f["L"].shape
        s = f["R"].shape[1]
        din, dout = k * p, q_ * s
        require(fused_fits((k, q_, p), (q_, s, k)),
                f"quantized {name} must take the fused branch")
        for bits in (8, 4):
            qc = quantize_monarch(f, bits)
            deq = dequantize_monarch(qc, k, p)
            qargs = (qc["Lq"], qc["Ls"], qc["Rq"], qc["Rs"])
            stored = qc["Lq"].numel() + qc["Rq"].numel()
            n_scales = qc["Ls"].numel() + qc["Rs"].numel()
            params = f["L"].numel() + f["R"].numel()
            for xdt in (f32, bf16):
                W = monarch_to_dense(deq["L"], deq["R"]).to(xdt)
                dn = dn_of(xdt)
                for T_ in (1, 8, 64, 512):
                    x = randn(T_, din, dtype=xdt)
                    y = monarch_fused_q(x, *qargs)
                    err, ok = close(y, monarch_fused_q_plain(x, *qargs), dn)
                    same = torch.equal(y, monarch_fused(x, deq["L"],
                                                        deq["R"]))
                    errs["monarch_fused_q"] = max(errs["monarch_fused_q"],
                                                  err)
                    bms, by = bound_ms(
                        T_ * (din + dout) * x.element_size() + stored
                        + 4 * n_scales, 2 * T_ * params, all_bf16=False)
                    emit({"phase": "kernel", "kernel": "monarch_fused_q",
                          "shape": name, "bits": bits, "T": T_,
                          "x_dtype": dn, "max_abs_err": err, "tol": TOL[dn],
                          **launch_shape(f["L"].shape, f["R"].shape, x,
                                         bits),
                          "bitwise_vs_monarch_fused": same,
                          **timings(
                              kernel=lambda: monarch_fused_q(x, *qargs),
                              plain=lambda: monarch_fused_q_plain(x, *qargs),
                              library=lambda: torch.matmul(x, W)),
                          "bound_ms": bms, "bound_by": by})
                    require(ok and same, f"monarch_fused_q {name} int{bits} "
                            f"T={T_} {dn}: err {err}, bitwise {same}")

    # -- 2f. bdmm_q directly and through the staged monarch_mm_q branch ------
    for bits in (8, 4):
        qc = quantize_monarch(sf, bits)
        deq = dequantize_monarch(qc, sd.k, sd.p)
        for T_ in (8, 512):
            for xdt in (f32, bf16):
                dn = dn_of(xdt)
                x3 = randn(T_, sd.k, sd.p, dtype=xdt)
                y = bdmm_q(x3, qc["Lq"], qc["Ls"])
                err, ok = close(y, bdmm_q_plain(x3, qc["Lq"], qc["Ls"]), dn)
                same = torch.equal(y, bdmm(x3, deq["L"]))
                again = torch.equal(y, bdmm_q(x3, qc["Lq"], qc["Ls"]))
                errs["bdmm_q"] = max(errs["bdmm_q"], err)
                xt = x3.transpose(0, 1)
                wt = deq["L"].to(xdt).transpose(1, 2)
                bms, by = bound_ms(
                    T_ * sd.k * (sd.p + sd.q) * x3.element_size()
                    + qc["Lq"].numel() + 4 * qc["Ls"].numel(),
                    2 * T_ * deq["L"].numel(), all_bf16=False)
                emit({"phase": "kernel", "kernel": "bdmm_q",
                      "shape": "direct", "bits": bits,
                      "x": [T_, sd.k, sd.p], "w": list(qc["Lq"].shape),
                      "x_dtype": dn, "max_abs_err": err, "tol": TOL[dn],
                      "bitwise_vs_bdmm": same, "deterministic": again,
                      **timings(
                          kernel=lambda: bdmm_q(x3, qc["Lq"], qc["Ls"]),
                          plain=lambda: bdmm_q_plain(x3, qc["Lq"], qc["Ls"]),
                          library=lambda: torch.matmul(xt, wt)),
                      "bound_ms": bms, "bound_by": by})
                require(ok and same and again, f"bdmm_q int{bits} T={T_} "
                        f"{dn}: err {err}, bitwise {same}, deterministic "
                        f"{again}")
                x = randn(T_, sd.din, dtype=xdt)
                qargs = (qc["Lq"], qc["Ls"], qc["Rq"], qc["Rs"])
                before = launches()
                y = ops.monarch_mm_q(x, *qargs)
                after = launches()
                require(after["bdmm_q"] - before["bdmm_q"] == 2
                        and after["monarch_fused_q"]
                        == before["monarch_fused_q"],
                        "staged monarch_mm_q must launch bdmm_q twice")
                err, ok = close(y, monarch_fused_q_plain(x, *qargs), dn)
                errs["bdmm_q"] = max(errs["bdmm_q"], err)
                emit({"phase": "kernel", "kernel": "bdmm_q",
                      "shape": "staged monarch_mm_q 4096x4096 nblocks=128",
                      "bits": bits, "T": T_, "x_dtype": dn,
                      "max_abs_err": err, "tol": TOL[dn]})
                require(ok, f"staged monarch_mm_q int{bits} T={T_} {dn}: "
                        f"err {err}")

    # B2/B5's ragged edges and other paths: T, p and q off every tile, p
    # with no 4-value unit (single-value loads; byte copies of int4 rows of
    # 5 bytes), a block too large for shared memory whole, small blocks
    # packed to a block; x with p
    # contiguous and through a transposed view (blocks contiguous, as in
    # stage 2); each shape through both instances where the decode one
    # takes it (bdmm_geometry's instance= override), fp32 and bf16 x
    for T_, k, q, p in ((1, 128, 8, 128), (5, 8, 48, 16), (16, 16, 8, 8),
                        (17, 4, 32, 32), (100, 8, 48, 16), (5, 5, 11, 7),
                        (33, 5, 11, 7), (7, 3, 5, 10), (40, 3, 5, 10),
                        (3, 2, 1024, 256), (40, 2, 1024, 256),
                        (9, 24, 40, 120)):
        w = torch.randn(k, q, p, generator=gb, device=dev) / p ** 0.5
        qws = {b: quantize_factor(w, b)
               for b in ((8, 4) if p % 2 == 0 else (8,))}
        for xdt in (f32, bf16):
            dn = dn_of(xdt)
            base = torch.randn(T_, p, k, generator=gb, device=dev).to(xdt)
            for layout, x3 in (("p_contiguous", base.transpose(1, 2)
                                .contiguous()), ("transposed",
                                                 base.transpose(1, 2))):
                for inst in ("decode", "prefill") if T_ <= 16 else \
                        ("prefill",):
                    out = BD._launch("bdmm", x3, w, None, w.dtype, q,
                                     instance=inst)
                    err, ok = close(out, bdmm_plain(x3, w), dn)
                    again = torch.equal(out, BD._launch(
                        "bdmm", x3, w, None, w.dtype, q, instance=inst))
                    same, errq = True, 0.0
                    for bits, (wq, sc) in qws.items():
                        deq = dequantize_factor(wq, sc, unpacked_dim=p)
                        oq = BD._launch("bdmm_q", x3, wq, sc, bits, q,
                                        instance=inst)
                        e, o = close(oq, bdmm_q_plain(x3, wq, sc), dn)
                        errq, ok = max(errq, e), ok and o
                        same = same and torch.equal(oq, BD._launch(
                            "bdmm", x3, deq, None, deq.dtype, q,
                            instance=inst))
                    torch.cuda.synchronize()
                    errs["bdmm"] = max(errs["bdmm"], err)
                    errs["bdmm_q"] = max(errs["bdmm_q"], errq)
                    emit({"phase": "kernel_shapes", "kernel": "bdmm",
                          "T": T_, "blocks": [k, q, p], "x_dtype": dn,
                          "x_layout": layout, "instance": inst,
                          "max_abs_err": err, "max_abs_err_q": errq,
                          "deterministic": again, "bitwise_q_vs_float": same,
                          "tol": TOL[dn]})
                    require(ok and again and same,
                            f"bdmm T={T_} ({k}, {q}, {p}) {dn} {layout} "
                            f"{inst}: err {err} / {errq}, deterministic "
                            f"{again}, bitwise {same}")

    # -- 2g. the span kernel over int8 pages ---------------------------------
    kq, ks = quantize_kv_page(k32)
    vq, vs = quantize_kv_page(v32)
    kd, vd = dequantize_kv_pages(kq, ks), dequantize_kv_pages(vq, vs)
    # page quantization on the card is bitwise the CPU's on the same rows
    kq_cpu, ks_cpu = quantize_kv_page(k32.cpu())
    same = (torch.equal(kq.cpu(), kq_cpu) and torch.equal(ks.cpu(), ks_cpu)
            and torch.equal(kd.cpu(), dequantize_kv_pages(kq_cpu, ks_cpu)))
    emit({"phase": "kv_quant", "pages": list(k32.shape),
          "bitwise_card_vs_cpu": same})
    require(same, "int8 KV page quantization differs card vs CPU")
    paged_q_summary = None
    for cname, (S, starts, spans) in cases.items():
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        sl = torch.tensor(spans, dtype=torch.int32, device=dev)
        for win in (GLOBAL_WINDOW, 48):
            for dt in (f32, bf16):
                dn = dn_of(dt)
                q = randn(B, S, H, hd, dtype=dt)
                args = (q, kq, vq, pt, st, sl, win)
                sc = dict(k_scales=ks, v_scales=vs)
                out = paged_attention_span(*args, **sc)
                err, ok = close(out, paged_attention_span_plain(
                    *args, ks, vs), dn)
                same = torch.equal(out, paged_attention_span(
                    q, kd, vd, pt, st, sl, win))
                again = torch.equal(out, paged_attention_span(*args, **sc))
                errs["paged_attention_span_q"] = max(
                    errs["paged_attention_span_q"], err)
                n_pages, n_pairs = span_work(starts, spans, win)
                eb = q.element_size()
                bms, by = bound_ms(
                    2 * B * S * H * hd * eb + 2 * n_pages * pg * KV * hd
                    + 2 * n_pages * KV * 4, 4 * hd * H * n_pairs,
                    all_bf16=False)
                qq, kk, vv, mask = sdpa_args(q, kd.to(dt), vd.to(dt), st, S,
                                             win)
                line = {
                    "phase": "kernel", "kernel": "paged_attention_span_q",
                    "case": cname, "S": S, "window": win, "q_dtype": dn,
                    "page_dtype": "int8", "pages_read": n_pages,
                    "max_abs_err": err, "tol": TOL[dn],
                    "bitwise_vs_paged_attention_span": same,
                    "launch": span_launch(S, H), "deterministic": again,
                    **timings(
                        kernel=lambda: paged_attention_span(*args, **sc),
                        plain=lambda: paged_attention_span_plain(
                            *args, ks, vs),
                        library=lambda: F.scaled_dot_product_attention(
                            qq, kk, vv, attn_mask=mask)),
                    "bound_ms": bms, "bound_by": by}
                emit(line)
                require(ok and same and again,
                        f"int8 paged {cname} window={win} {dn}: err {err}, "
                        f"bitwise {same}, deterministic {again}")
                if (cname == "decode" and win == GLOBAL_WINDOW
                        and dt == bf16):
                    paged_q_summary = line

    # the span kernel's other staging paths, float and int8 pages: rows that
    # are no 16-byte multiple (8- and 4-byte copies; hd 20 is zero-padded to
    # 4 values a read), and pages whose two buffers do not fit (stages 1)
    for hd_, pg_ in ((20, 16), (256, 64)):
        B_, H_, MP_ = 3, 4, 6
        pt_ = torch.from_numpy(prng.permutation(np.arange(1, 1 + B_ * MP_))
                               .reshape(B_, MP_).astype(np.int32)).to(dev)
        kk, vv = (randn(1 + B_ * MP_, pg_, 2, hd_) for _ in range(2))
        (kq_, ks_), (vq_, vs_) = quantize_kv_page(kk), quantize_kv_page(vv)
        kd_, vd_ = dequantize_kv_pages(kq_, ks_), dequantize_kv_pages(vq_, vs_)
        for S_, starts, spans in ((1, [0, 5, MP_ * pg_ - 1], [1, 1, 1]),
                                  (9, [0, 3, 20], [9, 4, 0])):
            st = torch.tensor(starts, dtype=torch.int32, device=dev)
            sl = torch.tensor(spans, dtype=torch.int32, device=dev)
            for dt in (f32, bf16):
                dn = dn_of(dt)
                q = randn(B_, S_, H_, hd_, dtype=dt)
                args = (q, kk.to(dt), vv.to(dt), pt_, st, sl, 7)
                err, ok = close(paged_attention_span(*args),
                                paged_attention_span_plain(*args), dn)
                qargs = (q, kq_, vq_, pt_, st, sl, 7)
                out = paged_attention_span(*qargs, k_scales=ks_,
                                           v_scales=vs_)
                errq, okq = close(out, paged_attention_span_plain(
                    *qargs, ks_, vs_), dn)
                same = torch.equal(out, paged_attention_span(
                    q, kd_, vd_, pt_, st, sl, 7))
                errs["paged_attention_span"] = max(
                    errs["paged_attention_span"], err)
                errs["paged_attention_span_q"] = max(
                    errs["paged_attention_span_q"], errq)
                emit({"phase": "kernel_shapes",
                      "kernel": "paged_attention_span", "hd": hd_,
                      "page": pg_, "S": S_, "window": 7, "dtype": dn,
                      "stages": span_geometry(S_, hd_, pg_, MP_).stages,
                      "max_abs_err": err, "max_abs_err_int8": errq,
                      "bitwise_int8_vs_float": same, "tol": TOL[dn]})
                require(ok and okq and same,
                        f"paged hd={hd_} page={pg_} S={S_} {dn}: err {err}, "
                        f"int8 err {errq}, bitwise {same}")

    # -- per-kernel summary: one layer of a bf16 decode step (T = 8), and
    # for B1/B4 one layer of a prefill step (T = 512) ------------------------
    proj = [(1024, 1024)] * 4 + [(1024, 4096), (4096, 1024)]
    T_dec, T_pre = 8, 512

    def layer_factors(nblocks, fused_qkv=False):
        fs = [init_monarch(gen, make_dims(din, dout, policy="paper",
                                          nblocks=nblocks), device=dev)
              for din, dout in proj]
        return [fuse_linears(fs[:3])] + fs[3:] if fused_qkv else fs

    def layer_bound(fs, staged: bool, weight_bytes: float = 4,
                    T_: int = T_dec):
        """bf16 activations in and out of each launch for T_ tokens;
        factors at ``weight_bytes`` a weight, plus fp32 block scales when
        quantized."""
        n_bytes = flops = 0
        for f in fs:
            k, q, p = f["L"].shape
            s = f["R"].shape[1]
            n = f["L"].numel() + f["R"].numel()
            acts = k * p + q * s + (2 * k * q if staged else 0)
            n_bytes += T_ * acts * 2 + n * weight_bytes
            if weight_bytes < 4:
                n_bytes += 4 * (k + q)
            flops += 2 * T_ * n
        return bound_ms(n_bytes, flops, all_bf16=False)

    def run_layer(fn, fs, xs):
        return lambda: [fn(x, f) for x, f in zip(xs, fs)]

    summary = {}
    fs = layer_factors(None)
    dense = [monarch_to_dense(f["L"], f["R"]).to(bf16) for f in fs]
    for T_, key in ((T_pre, "monarch_fused_T512"), (T_dec, "monarch_fused")):
        xs = [randn(T_, din, dtype=bf16) for din, _ in proj]
        kern = run_layer(lambda x, f: monarch_fused(x, f["L"], f["R"]), fs,
                         xs)
        t = timings(
            kernel=kern,
            plain=run_layer(lambda x, f: monarch_fused_plain(
                x, f["L"], f["R"]), fs, xs),
            library=run_layer(torch.matmul, dense, xs))
        summary[key] = {**summary_entry(t, *layer_bound(fs, False, T_=T_)),
                        "device_ms": _device_ms(kern), "T": T_,
                        "grid": [fused_geometry(f["L"].shape, f["R"].shape,
                                                T_, 2, 32).grid
                                 for f in fs]}

    # B2/B5: their call sets of phase 2b0, bf16 x; the decode layer (a)
    # at T = 8 (B5 int8, QKV fused) as before, at T = 512, and the FFN
    # call sets (c)-(g) at both
    def bdmm_entry(name, T_, bits) -> dict:
        line = bdmm_lines[name, T_, bits]
        return {**summary_entry(line, line["bound_ms"], line["bound_by"]),
                "T": T_, "launches": line["launches"]}

    a_set = "a_gpt2_layer_nb128"
    summary["bdmm"] = bdmm_entry(a_set, T_dec, 32)
    summary["bdmm_T512"] = bdmm_entry(a_set, T_pre, 32)
    summary["bdmm_q"] = bdmm_entry(a_set, T_dec, 8)
    summary["bdmm_q_T512"] = bdmm_entry(a_set, T_pre, 8)
    summary["bdmm_ffn"] = {
        f"{name} T={T_}": bdmm_entry(name, T_, 32)
        for name in ("c_nemotron_w1", "d_nemotron_w2", "e_codeqwen_w2",
                     "f_gemma2_w1_wg", "g_gemma2_w2")
        for T_ in (T_dec, T_pre)}
    summary["paged_attention_span"] = summary_entry(
        paged_summary, paged_summary["bound_ms"], paged_summary["bound_by"])

    # the quantized decode layer: fused QKV + wo + w1 + w2, int8 factors
    xq = [randn(T_dec, 1024, dtype=bf16)] + xs[3:]
    fs = layer_factors(None, fused_qkv=True)
    qfs = [quantize_monarch(f, 8) for f in fs]
    deqs = [dequantize_monarch(c, f["L"].shape[0], f["L"].shape[2])
            for c, f in zip(qfs, fs)]
    dense = [monarch_to_dense(d["L"], d["R"]).to(bf16) for d in deqs]

    def qcall(fn):
        return lambda x, c: fn(x, c["Lq"], c["Ls"], c["Rq"], c["Rs"])

    for T_, key in ((T_pre, "monarch_fused_q_T512"),
                    (T_dec, "monarch_fused_q")):
        xqt = xq if T_ == T_dec else [randn(T_, f["L"].shape[0]
                                            * f["L"].shape[2], dtype=bf16)
                                      for f in fs]
        kern = run_layer(qcall(monarch_fused_q), qfs, xqt)
        t = timings(kernel=kern,
                    plain=run_layer(qcall(monarch_fused_q_plain), qfs, xqt),
                    library=run_layer(torch.matmul, dense, xqt))
        summary[key] = {
            **summary_entry(t, *layer_bound(fs, False, weight_bytes=1,
                                            T_=T_)),
            "device_ms": _device_ms(kern), "T": T_,
            "grid": [fused_geometry(f["L"].shape, f["R"].shape, T_, 2,
                                    8).grid for f in fs]}

    summary["paged_attention_span_q"] = summary_entry(
        paged_q_summary, paged_q_summary["bound_ms"],
        paged_q_summary["bound_by"])

    # -- 2m. B1/B4 over a mixture-of-experts layer's stacked experts, one
    # launch a projection over the expert axis (monarch_fused_experts /
    # monarch_fused_q_experts): qwen2-moe-a2.7b's and granite-moe-1b-a400m's
    # expert call sets (B1: up (= gate) and down; B4: up+gate fused and
    # down, int8), at decode (8 tokens: 4 capacity rows an expert) and
    # prefill (8 x 64 tokens: 42 / 160 rows), bf16 and fp32 x; each launch
    # torch.equal to a loop of single-expert launches, B4 bitwise B1 on
    # the dequantized factors; the library call one torch.bmm over the
    # stack's dense matrices -------------------------------------------------
    from repro_torch.kernels.monarch import (monarch_fused_experts,
                                             monarch_fused_experts_plain,
                                             monarch_fused_q_experts,
                                             monarch_fused_q_experts_plain)

    def expert_factors(E, din, dout, policy):
        dims = make_dims(din, dout, policy=policy)
        require(fused_fits(dims.l_shape, dims.r_shape),
                f"expert factors {din}x{dout} must take the fused branch")
        return {"L": randn(E, *dims.l_shape) * math.sqrt(1.0 / dims.p),
                "R": randn(E, *dims.r_shape) * math.sqrt(1.0 / dims.k)}

    def expert_timings(kern, plain, library) -> dict:
        """``timings`` of the kernel and the library call; the plain
        version (E plain products, 5-20 ms a call) in 3 loops of 2."""
        t = timings(kernel=kern, library=library)
        (t["plain_ms"], t["plain_spread"],
         t["plain_card_ms"]) = time_ms(plain, iters=2, repeats=3)
        return t

    def expert_line(arch, proj, f, rows, xdt, bits):
        """One expert-batched launch against its plain version, a loop of
        single-expert launches, the library's bmm and (B4) B1 on the
        dequantized factors; its blocks, bound and times."""
        E, k, q_, p = f["L"].shape
        s = f["R"].shape[2]
        din, dout = k * p, q_ * s
        dn = dn_of(xdt)
        x = randn(E, rows, din, dtype=xdt)
        if bits:
            qc = quantize_monarch(f, bits)
            deq = dequantize_monarch(qc, k, p)
            qa = (qc["Lq"], qc["Ls"], qc["Rq"], qc["Rs"])
            kern = lambda: monarch_fused_q_experts(x, *qa)  # noqa: E731
            plain = lambda: monarch_fused_q_experts_plain(x, *qa)  # noqa
            one = lambda e: monarch_fused_q(x[e], *(a[e] for a in qa))  # noqa
            W = monarch_to_dense(deq["L"], deq["R"]).to(xdt)
            w_bytes = qc["Lq"].numel() + qc["Rq"].numel() + 4 * (
                qc["Ls"].numel() + qc["Rs"].numel())
            kind = "monarch_fused_q_experts"
        else:
            kern = lambda: monarch_fused_experts(x, f["L"], f["R"])  # noqa
            plain = lambda: monarch_fused_experts_plain(  # noqa: E731
                x, f["L"], f["R"])
            one = lambda e: monarch_fused(x[e], f["L"][e], f["R"][e])  # noqa
            W = monarch_to_dense(f["L"], f["R"]).to(xdt)
            w_bytes = 4 * (f["L"].numel() + f["R"].numel())
            kind = "monarch_fused_experts"
        y = kern()
        err, ok = close(y, plain(), dn)
        loop = torch.equal(y, torch.stack([one(e) for e in range(E)]))
        twin = torch.equal(y, monarch_fused_experts(
            x, deq["L"], deq["R"])) if bits else True
        torch.cuda.synchronize()
        errs[kind] = max(errs[kind], err)
        params = (f["L"].numel() + f["R"].numel()) // E
        bms, by = bound_ms(E * rows * (din + dout) * x.element_size()
                           + w_bytes, 2 * E * rows * params, all_bf16=False)
        g = fused_geometry((k, q_, p), (q_, s, k), rows, x.element_size(),
                           bits or 32)
        line = {"phase": "kernel", "kernel": kind, "model": arch,
                "projection": proj, "experts": E, "rows_per_expert": rows,
                "factors": [[k, q_, p], [q_, s, k]], "x_dtype": dn,
                **({"bits": bits} if bits else {}),
                "max_abs_err": err, "tol": TOL[dn],
                "equal_to_single_launches": loop,
                **({"bitwise_vs_monarch_fused_experts": twin}
                   if bits else {}),
                "launch": {"blocks": g.grid * E, "blocks_per_expert": g.grid,
                           "tile_t": g.tile_t, "q_group": g.q_group,
                           "slab": g.slab, "chunk": g.chunk,
                           "smem_bytes": g.smem_bytes},
                **expert_timings(kern, plain, lambda: torch.bmm(x, W)),
                "bound_ms": bms, "bound_by": by}
        emit(line)
        require(ok and loop and twin, f"{kind} {arch} {proj} rows={rows} "
                f"{dn}: err {err}, equal to single launches {loop}, "
                f"bitwise B1 {twin}")
        return line

    expert_sets = {}
    for arch in MOE_ARCHS:
        mcfg = get_config(arch)
        mc = mcfg.moe
        d, de, E = mcfg.d_model, mc.d_expert, mc.n_slots
        pol = mcfg.monarch.policy
        w1, w2 = (expert_factors(E, d, de, pol),
                  expert_factors(E, de, d, pol))
        w1g = fuse_linears([w1, expert_factors(E, d, de, pol)])
        expert_sets[arch] = (w1, w2, w1g)
        for rows in (_moe_rows(mc, 8), _moe_rows(mc, 8 * 64)):
            for xdt in (bf16, f32):
                for proj, f in (("w1", w1), ("w2", w2)):
                    expert_line(arch, proj, f, rows, xdt, 0)
                for proj, f in (("w1g", w1g), ("w2", w2)):
                    expert_line(arch, proj, f, rows, xdt, 8)
    # the summary's yardstick: one qwen2-moe-a2.7b decode layer's expert
    # projections, bf16 x, 4 rows an expert: B1 up, gate and down; B4
    # (int8, up+gate fused) up+gate and down
    w1, w2, w1g = expert_sets["qwen2-moe-a2.7b"]
    rows = _moe_rows(get_config("qwen2-moe-a2.7b").moe, T_dec)
    E = w1["L"].shape[0]

    def stack_bound(fs, weight_bytes, T_):
        n_bytes = flops = 0
        for f in fs:
            _, k, q_, p = f["L"].shape
            s = f["R"].shape[2]
            n = (f["L"].numel() + f["R"].numel()) // E
            n_bytes += E * (T_ * (k * p + q_ * s) * 2 + n * weight_bytes
                            + (4 * (k + q_) if weight_bytes < 4 else 0))
            flops += 2 * E * T_ * n
        return bound_ms(n_bytes, flops, all_bf16=False)

    for key, fs, bits in (("monarch_fused_experts", [w1, w1, w2], 0),
                          ("monarch_fused_q_experts", [w1g, w2], 8)):
        xs_e = [randn(E, rows, f["L"].shape[1] * f["L"].shape[3],
                      dtype=bf16) for f in fs]
        if bits:
            qs = [quantize_monarch(f, bits) for f in fs]
            deqs = [dequantize_monarch(c, f["L"].shape[1], f["L"].shape[3])
                    for c, f in zip(qs, fs)]
            args = [(c["Lq"], c["Ls"], c["Rq"], c["Rs"]) for c in qs]
            kern = lambda: [monarch_fused_q_experts(x, *a)  # noqa: E731
                            for x, a in zip(xs_e, args)]
            plain = lambda: [monarch_fused_q_experts_plain(x, *a)  # noqa
                             for x, a in zip(xs_e, args)]
        else:
            deqs = fs
            kern = lambda: [monarch_fused_experts(x, f["L"], f["R"])  # noqa
                            for x, f in zip(xs_e, fs)]
            plain = lambda: [monarch_fused_experts_plain(  # noqa: E731
                x, f["L"], f["R"]) for x, f in zip(xs_e, fs)]
        Ws = [monarch_to_dense(dq["L"], dq["R"]).to(bf16) for dq in deqs]
        t = expert_timings(kern, plain, lambda: [
            torch.bmm(x, W) for x, W in zip(xs_e, Ws)])
        summary[key] = {
            **summary_entry(t, *stack_bound(fs, 1 if bits else 4, rows)),
            "device_ms": _device_ms(kern), "T": rows, "experts": E,
            "grid": [fused_geometry(f["L"].shape[1:], f["R"].shape[1:],
                                    rows, 2, bits or 32).grid * E
                     for f in fs]}
        del Ws
    del expert_sets, w1, w2, w1g
    torch.cuda.empty_cache()
    emit({"phase": "kernel_summary",
          "what": "one bf16 decode layer at T=8 (B1/B4: its projections, "
                  "B4 int8 with fused QKV; B2/B5: the same at 128 blocks; "
                  "B3/B6: one decode call); B1/B2/B4/B5 also one prefill "
                  "layer at T=512 (*_T512); bdmm_ffn: B2 at the FFN call "
                  "sets; *_experts: one qwen2-moe-a2.7b decode layer's "
                  "expert projections over its 64 slots, 4 rows each (B1 "
                  "up, gate, down; B4 int8 up+gate, down); device_ms: "
                  "torch.profiler's kernel time, grid: blocks per launch",
          "summary": summary})

    # -- 2h. what spreading B1 over the SMs would buy at decode: its device
    # time at T = 8 with fused_geometry's grid (one block a q-block) against
    # the same kernel with R[i]'s rows cut into the fewest slabs that give
    # at least one block per SM (132); both launches' arguments packed by
    # kernels/monarch.py:_launch_args --------------------------------------
    from repro_torch.kernels import monarch as M

    lib = _build.library("monarch", "monarch_fused_launch", M._ARGTYPES)
    for name, (din, dout) in layer_shapes.items():
        L, R = factors[name]["L"], factors[name]["R"]
        k, q, p = L.shape
        s = R.shape[1]
        x = randn(T_dec, din, dtype=bf16)
        line = {"phase": "monarch_geometry", "shape": name, "T": T_dec,
                "x_dtype": "bfloat16"}
        for variant, slab in (("plan", None),
                              ("split_132", -(-s // -(-132 // q)))):
            args = M._launch_args("monarch_fused", k, q, p, s, T_dec, bf16,
                                  L.dtype, slab)
            y = torch.empty(T_dec, dout, dtype=bf16, device=dev)

            def launch(args=args, y=y):
                _build.check(lib.monarch_fused_launch(
                    x.data_ptr(), L.data_ptr(), R.data_ptr(), y.data_ptr(),
                    args, _build.stream_of(x)), "monarch_geometry")

            launch()
            err, ok = close(y, monarch_fused_plain(x, L, R), "bfloat16")
            require(ok, f"monarch_geometry {name} {variant}: err {err}")
            line[variant] = {"grid": args[9], "slab": args[7],
                             "smem_bytes": args[11],
                             "device_ms": _device_ms(launch, 20),
                             "max_abs_err": err}
        emit(line)

    # -- 2i. how far to split the span kernel's page axis: its time at the
    # decode call set (bf16, global window) with 1, 2, 4, 8 pages a split
    # and unsplit (one split of all MP pages), and at the two prefill call
    # sets with 4 to 32 pages a split and unsplit --------------------------
    for cname, choices in (("decode", (1, 2, 4, 8, MP)),
                           ("prefill", (4, 8, 16, MP)),
                           ("prefill512", (8, 16, 32, MP))):
        S, starts, spans = cases[cname]
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        sl = torch.tensor(spans, dtype=torch.int32, device=dev)
        q = randn(B, S, H, hd, dtype=bf16)
        args = (q, k32.to(bf16), v32.to(bf16), pt, st, sl, GLOBAL_WINDOW)
        ref = paged_attention_span_plain(*args)
        line = {"phase": "span_geometry", "case": cname, "S": S,
                "dtype": "bfloat16", "planned_pps": span_geometry(
                    S, hd, pg, MP).pps}
        for pps in choices:
            def call(pps=pps):
                return PG._span(*args, None, None, "paged_attention_span",
                                pps)
            err, ok = close(call(), ref, "bfloat16")
            require(ok, f"span_geometry {cname} pps={pps}: err {err}")
            g = span_geometry(S, hd, pg, MP, pps)
            t = timings(kernel=call)
            line["unsplit" if pps == MP else f"pps_{pps}"] = {
                "splits": g.n_splits, "blocks": B * H * g.blocks,
                "ms": t["kernel_ms"], "card_ms": t["kernel_card_ms"],
                "max_abs_err": err}
        emit(line)

    # -- 2j. B2's launches compared, bf16 x, fp32 factors, both stages as
    # ops.monarch_mm issues them: at decode (T = 8) the planned lanes a row
    # against 4 and 32 (a block holds 256 / lanes rows); at prefill
    # (T = 512) the planned group of diagonal blocks a block against 1 and
    # 8; and the threshold between the instances: each at T = 8 and 16 ----
    def bdmm_run(fs, xs, **override):
        def run():
            outs = []
            for x, f in zip(xs, fs):
                k, q, p = f["L"].shape
                u = BD._launch("bdmm", x.view(x.shape[0], k, p), f["L"], None,
                               f["L"].dtype, q, **override)
                outs += [u, BD._launch("bdmm", u.transpose(1, 2), f["R"],
                                       None, f["R"].dtype, f["R"].shape[1],
                                       **override)]
            return outs
        return run

    def grids(fs, T_, **override):
        out = []
        for f in fs:
            k, q, p = f["L"].shape
            for blocks, contiguous in (((k, q, p), True),
                                       ((q, f["R"].shape[1], k), False)):
                g = BD.bdmm_geometry(T_, *blocks, 2, 32, contiguous,
                                     **override)
                out.append([g.instance, g.group, g.slab, g.tile_t, g.grid])
        return out

    for name, T_, knob, choices in (
            ("a_gpt2_layer_nb128", T_dec, "lanes", (None, 4, 32)),
            ("d_nemotron_w2", T_dec, "lanes", (None, 4, 32)),
            ("e_codeqwen_w2", T_dec, "lanes", (None, 4, 32)),
            ("a_gpt2_layer_nb128", T_pre, "group", (None, 1, 8)),
            ("c_nemotron_w1", T_pre, "group", (None, 1, 8)),
            ("d_nemotron_w2", T_pre, "group", (None, 1, 8)),
            ("e_codeqwen_w2", T_pre, "group", (None, 1, 8)),
            ("a_gpt2_layer_nb128", 8, "instance", ("decode", "prefill")),
            ("a_gpt2_layer_nb128", 16, "instance", ("decode", "prefill")),
            ("d_nemotron_w2", 8, "instance", ("decode", "prefill")),
            ("d_nemotron_w2", 16, "instance", ("decode", "prefill"))):
        fs = bdmm_sets[name][0]
        xs = [torch.randn(T_, f["L"].shape[0] * f["L"].shape[2], generator=gb,
                          device=dev).to(bf16) for f in fs]
        line = {"phase": "bdmm_geometry", "call_set": name, "T": T_,
                "knob": knob, "x_dtype": "bfloat16"}
        for choice in choices:
            override = {} if choice is None else {knob: choice}
            run = bdmm_run(fs, xs, **override)
            outs = run()
            err, ok = 0.0, True
            for i, (x, f) in enumerate(zip(xs, fs)):
                k, q, p = f["L"].shape
                u, y = outs[2 * i], outs[2 * i + 1]
                for out, ref in ((u, bdmm_plain(x.view(T_, k, p), f["L"])),
                                 (y, bdmm_plain(u.transpose(1, 2), f["R"]))):
                    e, o = close(out, ref, "bfloat16")
                    err, ok = max(err, e), ok and o
            require(ok, f"bdmm_geometry {name} T={T_} {knob}={choice}: "
                        f"err {err}")
            t = timings(kernel=run)
            line["plan" if choice is None else f"{knob}_{choice}"] = {
                "ms": t["kernel_ms"], "card_ms": t["kernel_card_ms"],
                "max_abs_err": err,
                "stages": grids(fs, T_, **override)}
        emit(line)

    # -- 2k. quantize_kv_write: the int8 KV write, one call of a memset and
    # three launches (csrc/kv_write.cu), torch.equal to its plain version
    # on the card, pages and scales, on writes built as models/layers.py
    # builds them over a 513-page pool of 16-row pages holding stored rows
    # (recycled pages): a page started at offset 0, pages whose scale grows
    # (the last one also repeated in its rescale set by the table's clamp),
    # a shared page in two rows' rescale sets that no row writes, an inert
    # row whose rescale set is the sink over and over; S = 1, 64 and 512
    # at gpt2-medium's KV 16 x hd 64 and nemotron-4-15b's KV 8 x hd 128,
    # bf16 and fp32 rows.  The plain version runs under PyTorch's
    # deterministic algorithms, whose index_put keeps the last of duplicate
    # indices as the kernel does (padding rows collide on the sink);
    # otherwise the card resolves those in no fixed order.  Times: the
    # write repeated on its own output (reset pages rescale by 0 each
    # time, grown ones by 1.0); the bound counts that call's bytes --------
    from repro_torch.kernels import kv_write as KW

    def last_wins(fn, *args, **kw):
        torch.use_deterministic_algorithms(True)
        try:
            return fn(*args, **kw)
        finally:
            torch.use_deterministic_algorithms(False)

    def kv_case(S_, KV_, hd_, rows_dt, seed):
        """Pages, scales and one write's (phys, off, rows, rescale set)."""
        g_ = torch.Generator(device=dev)
        g_.manual_seed(seed)
        B_, pg_, MP_ = 8, 16, 64
        pages_, scales_ = quantize_kv_page(torch.randn(
            1 + B_ * MP_, pg_, KV_, hd_, generator=g_, device=dev))
        table = (1 + torch.arange(B_ * MP_, device=dev)).view(B_, MP_)
        nK = -(-S_ // pg_) + 1
        table[6] = 0                              # inert: every entry sink
        table[7, 6] = table[0, 2 + nK - 1]        # shared, written by none
        starts_ = [32, 100, 1024 - min(S_, 200), 320, 5, 700, 0, 95]
        spans_ = [S_, min(S_, 37), min(S_, 200), min(S_, 16), min(S_, 3),
                  max(1, S_ // 2), 0, 1]
        q_pos = torch.tensor(starts_, device=dev)[:, None] + torch.arange(
            S_, device=dev)[None, :]
        phys_ = torch.gather(table, 1, torch.clamp(q_pos // pg_,
                                                   max=MP_ - 1))
        off_ = q_pos % pg_
        valid = torch.arange(S_, device=dev)[None, :] < torch.tensor(
            spans_, device=dev)[:, None]
        phys_ = torch.where(valid, phys_, torch.zeros_like(phys_))
        resc_ = torch.gather(table, 1, torch.clamp(
            q_pos[:, :1] // pg_ + torch.arange(nK, device=dev)[None, :], 0,
            MP_ - 1))
        grow = torch.tensor([1.0, 4.0, 6.0, 1.0, 2.0, 3.0, 1.0, 1.0],
                            device=dev)[:, None, None, None]
        rows_ = (torch.randn(B_, S_, KV_, hd_, generator=g_, device=dev)
                 * grow).to(rows_dt)
        return pages_, scales_, (phys_, off_, rows_, resc_)

    def kv_write_bytes(sc0, sc1, phys_, off_, rows_, resc_, pg_, hd_):
        """What one call must move: the rows read, the int8 rows written,
        the indices, the touched pages' scales read and written, and the
        stored rows of each (rescale-set page, head) whose ratio old/new
        is not 1: read and written where the old scale (after the reset)
        is above 0, only written (zeros) where it is 0."""
        KV_ = sc0.shape[1]
        reset = torch.where(off_ == 0, phys_, torch.zeros_like(phys_))
        s0 = sc0.index_fill(0, reset.reshape(-1), 0.0)
        resc_pages = resc_.reshape(-1).unique()
        moved = ((sc1 > 0) & (s0 != sc1))[resc_pages]
        from_zero = moved & (s0[resc_pages] == 0)
        touched = torch.cat([phys_.reshape(-1), reset.reshape(-1)]).unique()
        written = (phys_ * pg_ + off_).reshape(-1).unique().numel()
        return (rows_.numel() * rows_.element_size()
                + written * KV_ * hd_
                + 8 * (phys_.numel() + off_.numel() + resc_.numel())
                + 2 * 4 * KV_ * touched.numel()
                + (2 * int(moved.sum()) - int(from_zero.sum())) * pg_ * hd_)

    kv_summary = None
    for S_ in (1, 64, 512):
        for KV_, hd_ in ((16, 64), (8, 128)):
            for rdt in (bf16, f32):
                pages0, scales0, (phys_, off_, rows_, resc_) = kv_case(
                    S_, KV_, hd_, rdt, S_ + KV_)
                pk, sk = pages0.clone(), scales0.clone()
                before = launches()["quantize_kv_write"]
                KW.quantize_kv_write(pk, sk, phys_, off_, rows_,
                                     rescale_phys=resc_)
                n_launch = launches()["quantize_kv_write"] - before
                pp, sp = pages0.clone(), scales0.clone()
                last_wins(quantize_kv_write, pp, sp, phys_, off_, rows_,
                          rescale_phys=resc_)
                pc, sc_ = (t.to("cpu", copy=True) for t in (pages0, scales0))
                last_wins(quantize_kv_write, pc, sc_, phys_.cpu(),
                          off_.cpu(), rows_.cpu(), rescale_phys=resc_.cpu())
                pa, sa = pages0.clone(), scales0.clone()
                KW.quantize_kv_write(pa, sa, phys_, off_, rows_,
                                     rescale_phys=resc_)
                same = torch.equal(pk, pp) and torch.equal(sk, sp)
                same_cpu = (torch.equal(pk.cpu(), pc)
                            and torch.equal(sk.cpu(), sc_))
                again = torch.equal(pk, pa) and torch.equal(sk, sa)
                reset_pages = int(torch.where(
                    off_ == 0, phys_, torch.zeros_like(phys_)).unique()
                    .numel())
                grown = int((sk > scales0)[1:].any(dim=1).sum())
                # the timed state: three writes in, then one more, whose
                # work the bound counts
                tp_, ts_ = pk.clone(), sk.clone()
                for _ in range(2):
                    KW.quantize_kv_write(tp_, ts_, phys_, off_, rows_,
                                         rescale_phys=resc_)
                sc0 = ts_.clone()
                KW.quantize_kv_write(tp_, ts_, phys_, off_, rows_,
                                     rescale_phys=resc_)
                bms, by = bound_ms(kv_write_bytes(
                    sc0, ts_, phys_, off_, rows_, resc_, 16, hd_), 0, False)
                tq_, tqs = tp_.clone(), ts_.clone()
                line = {"phase": "kernel", "kernel": "quantize_kv_write",
                        "S": S_, "B": 8, "KV": KV_, "hd": hd_, "page": 16,
                        "pool_pages": pages0.shape[0],
                        "rows_dtype": dn_of(rdt),
                        "rescale_set": list(resc_.shape),
                        "pages_reset": reset_pages,
                        "pages_grown": grown,
                        "launches_per_call": n_launch,
                        "bitwise_vs_plain_on_card": same,
                        "bitwise_vs_plain_on_cpu": same_cpu,
                        "deterministic": again, "max_abs_err": 0.0,
                        **timings(
                            kernel=lambda: KW.quantize_kv_write(
                                tp_, ts_, phys_, off_, rows_,
                                rescale_phys=resc_),
                            plain=lambda: quantize_kv_write(
                                tq_, tqs, phys_, off_, rows_,
                                rescale_phys=resc_)),
                        "library_ms": None, "library_card_ms": None,
                        "bound_ms": bms, "bound_by": by}
                emit(line)
                require(same and same_cpu and again and n_launch == 1,
                        f"quantize_kv_write S={S_} KV={KV_} hd={hd_} "
                        f"{dn_of(rdt)}: bitwise on card {same}, vs CPU "
                        f"{same_cpu}, deterministic {again}, launches "
                        f"{n_launch}")
                require(reset_pages > 1 and grown > 0,
                        f"quantize_kv_write S={S_}: the case must reset "
                        f"and grow pages")
                if S_ == 1 and KV_ == 16 and rdt == bf16:
                    kv_summary = line
    # the write path never waits for the device: a synchronizing call in
    # it raises here
    torch.cuda.set_sync_debug_mode("error")
    try:
        KW.quantize_kv_write(tp_, ts_, phys_, off_, rows_,
                             rescale_phys=resc_)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    summary["quantize_kv_write"] = summary_entry(
        kv_summary, kv_summary["bound_ms"], kv_summary["bound_by"])

    # -- 2l. sample_tokens (X3): the token draw and key split, one call of
    # two launches (csrc/sample.cu).  Its Gumbel noise (the debug entry)
    # torch.equal to core.prng.gumbel on the card, and its tokens and
    # split keys torch.equal to the plain version's, at gpt2-medium's and
    # nemotron-4-15b's padded vocabularies, B = 8: rows at temperatures
    # 0.5-1.3, greedy rows (0 and below), rows that do not sample this
    # step; with the draw on and off (a greedy batch).  The CPU's plain
    # version is a reading: its log may differ from the card's logf by an
    # ulp.  The bound counts the logits read once and the keys, and the
    # drawing rows' fp32 operations (7 a column; the threefry rounds'
    # integer work has no rate in the table) ---------------------------
    from repro_torch.core import prng as PR
    from repro_torch.kernels import sample as SM

    temps8 = torch.tensor([0.8, 0.8, 0.0, 1.3, 0.8, -1.0, 0.8, 0.5],
                          device=dev)
    mask8 = torch.tensor([1, 1, 1, 1, 0, 1, 1, 0], dtype=torch.bool,
                         device=dev)
    keys8 = PR.to_i32(torch.stack([PR.prng_key(7 + i) for i in
                                     range(8)])).to(dev)
    x3_summary = None
    for vname, Vp in (("gpt2-medium", gpt2.vocab_padded),
                      ("nemotron-4-15b",
                       get_config("nemotron-4-15b").vocab_padded)):
        lg = randn(8, Vp) * 3.0
        draw_keys = PR.to_i32(PR.split(PR.from_i32(keys8))[:, 0])
        same_noise = torch.equal(SM.gumbel_noise(draw_keys, Vp),
                                 PR.gumbel(PR.from_i32(draw_keys), Vp))
        for draw in (True, False):
            ka, kb, kc = (keys8.clone() for _ in range(3))
            before = launches()["sample_tokens"]
            ta = SM.sample_tokens(lg, temps8, ka, mask8, draw)
            n_launch = launches()["sample_tokens"] - before
            tb = SM.sample_tokens_plain(lg, temps8, kb, mask8, draw)
            same = torch.equal(ta, tb) and torch.equal(ka, kb)
            again = torch.equal(ta, SM.sample_tokens(lg, temps8, kc, mask8,
                                                     draw))
            kd = keys8.cpu()
            on_cpu = SM.sample_tokens_plain(lg.cpu(), temps8.cpu(), kd,
                                            mask8.cpu(), draw)
            n_draw = int((temps8 > 0).sum()) if draw else 0
            bms, by = bound_ms(8 * Vp * 4 + 8 * (4 + 1 + 16 + 4),
                               7 * n_draw * Vp, False)
            kt, kp = keys8.clone(), keys8.clone()
            line = {"phase": "kernel", "kernel": "sample_tokens",
                    "vocab": vname, "V": Vp, "B": 8, "draw": draw,
                    "drawing_rows": n_draw,
                    "launches_per_call": n_launch,
                    "bitwise_noise_vs_plain": same_noise,
                    "bitwise_tokens_and_keys_vs_plain": same,
                    "deterministic": again,
                    "tokens_equal_cpu_plain": torch.equal(ta.cpu(), on_cpu)
                    and torch.equal(kd, kb.cpu()),
                    "max_abs_err": 0.0,
                    **timings(kernel=lambda: SM.sample_tokens(
                                  lg, temps8, kt, mask8, draw),
                              plain=lambda: SM.sample_tokens_plain(
                                  lg, temps8, kp, mask8, draw)),
                    "library_ms": None, "library_card_ms": None,
                    "bound_ms": bms, "bound_by": by}
            emit(line)
            require(same_noise and same and again and n_launch == 1,
                    f"sample_tokens V={Vp} draw={draw}: noise bitwise "
                    f"{same_noise}, tokens and keys bitwise {same}, "
                    f"deterministic {again}, launches {n_launch}")
            if vname == "nemotron-4-15b" and draw:
                x3_summary = line
        # the legacy ServeEngine's block draw: one key for the whole (8,
        # Vp) block, row b's column j from the flat count b * Vp + j, the
        # key read and never split; greedy through the same kernel
        bkey = PR.to_i32(PR.split(PR.prng_key(3))[1])[None].to(dev)
        tb8 = torch.full((8,), SAMPLE_TEMPERATURE, device=dev)
        same_noise = torch.equal(
            SM.gumbel_noise(bkey, Vp, rows=8),
            PR.gumbel(PR.from_i32(bkey.reshape(2)), 8 * Vp).reshape(8, Vp))
        for draw in (True, False):
            before = launches()["sample_tokens"]
            ta = SM.sample_block(lg, tb8, bkey, draw)
            n_launch = launches()["sample_tokens"] - before
            same = torch.equal(ta, SM.sample_block_plain(lg, tb8, bkey,
                                                         draw))
            again = torch.equal(ta, SM.sample_block(lg, tb8, bkey, draw))
            key_kept = torch.equal(bkey.cpu(), PR.to_i32(
                PR.split(PR.prng_key(3))[1])[None])
            on_cpu = SM.sample_block_plain(lg.cpu(), tb8.cpu(), bkey.cpu(),
                                           draw)
            bms, by = bound_ms(8 * Vp * 4 + 8 * (4 + 4) + 8,
                               7 * 8 * Vp if draw else 0, False)
            line = {"phase": "kernel", "kernel": "sample_tokens",
                    "mode": "block", "vocab": vname, "V": Vp, "B": 8,
                    "draw": draw, "launches_per_call": n_launch,
                    "bitwise_noise_vs_plain": same_noise,
                    "bitwise_tokens_vs_plain": same,
                    "deterministic": again, "key_unchanged": key_kept,
                    "tokens_equal_cpu_plain": torch.equal(ta.cpu(), on_cpu),
                    "max_abs_err": 0.0,
                    **timings(kernel=lambda: SM.sample_block(lg, tb8, bkey,
                                                             draw),
                              plain=lambda: SM.sample_block_plain(
                                  lg, tb8, bkey, draw)),
                    "library_ms": None, "library_card_ms": None,
                    "bound_ms": bms, "bound_by": by}
            emit(line)
            require(same_noise and same and again and key_kept
                    and n_launch == 1,
                    f"sample_block V={Vp} draw={draw}: noise bitwise "
                    f"{same_noise}, tokens bitwise {same}, deterministic "
                    f"{again}, key kept {key_kept}, launches {n_launch}")
    summary["sample_tokens"] = summary_entry(
        x3_summary, x3_summary["bound_ms"], x3_summary["bound_by"])
    phase_done("2 kernels")

    # the gloo worlds of phases 5c, 3j and 5e run in the background, where
    # this process's phases leave the card room: 5c's (2 ranks of ~3 GB)
    # beside phases 3c-3d (which reserve up to ~56 GB), then 3j's (4 ranks
    # of ~7 GB) and 5e's (2 ranks of up to ~14 GB), one at a time, beside
    # 3e-3h (up to ~38 GB).  All are joined before phase 3i, whose remat
    # "none" step alone takes ~45 GB, and none runs beside the timed
    # kernels of phases 2 and 5a
    import concurrent.futures
    import shutil

    worlds = concurrent.futures.ThreadPoolExecutor(1)
    tp_pool = concurrent.futures.ThreadPoolExecutor(1)

    # -- 3. serve gpt2-medium at full width ---------------------------------
    serve = _serve

    def kv_writes_each_step(prof: dict, what: str, n_layers: int) -> None:
        """An int8 pool's windows run quantize_kv_write twice a layer a
        step."""
        for wname, w in prof.items():
            n = w["launches_per_step"].get("quantize_kv_write")
            require(n == 2 * n_layers,
                    f"{what} {wname} window: quantize_kv_write ran {n} "
                    f"times a step, not {2 * n_layers}")

    cfg = dataclasses.replace(gpt2, monarch=dataclasses.replace(
        gpt2.monarch, backend="pallas"))
    params = T.init_params(cfg, seed=0, device=dev)
    eng, reqs, counts, dt, out, prompt_toks = serve(cfg, params, 8, 32, 256,
                                                    32, seed=0)
    st_ = eng.stats
    # what the tensor-parallel serve of phase 5 is read against
    bf16_serve = {"tokens": [list(r.output_tokens) for r in reqs],
                  "checksum": _checksum(params), "steps": st_["mixed_steps"]}
    fp_serve = {"tokens_per_s": out / dt, "kv_dtype": eng.kv_dtype,
                "pool_pages": eng.pool_host.n_pages - 1,
                "pool_bytes": eng.pool_host.stats().pool_bytes,
                "decode_weight_bytes": decode_weight_bytes(eng.params),
                "decoder_weight_bytes": decode_weight_bytes(
                    eng.params["decoder"])}
    emit({"phase": "serve", "model": "gpt2-medium", "dtype": cfg.dtype,
          "layers": cfg.n_layers, "requests": len(reqs),
          "prompt_tokens": prompt_toks, "new_tokens": out,
          "seconds": dt, "tokens_per_s": out / dt,
          "steps": st_["mixed_steps"],
          "kernel_dispatches": st_["kernel_dispatches"],
          "dense_fallbacks": st_["dense_fallbacks"], "launches": counts,
          **{k: fp_serve[k] for k in ("kv_dtype", "pool_pages", "pool_bytes",
                                      "decode_weight_bytes",
                                      "decoder_weight_bytes")},
          "graphs": _graphs_replayed(eng, "serve")})
    require(counts["monarch_fused"] > 0, "serve launched no monarch_fused")
    require(counts["paged_attention_span"] > 0,
            "serve launched no paged_attention_span")
    require(st_["dense_fallbacks"] == 0, "serve fell back to dense attention")
    require(counts["sample_tokens"] > 0,
            "the serve drew no token through sample_tokens")
    serve_counts = dict(counts)
    del eng

    # phase 5c's world, started here: the tp = 1 snapshot the ranks
    # restore at tp = 2 (the plain trace after 3 steps), and its jobs:
    # phase 4's fp32 traces, over int8 KV pages, with int8 and int4
    # factors, and phase 3's bf16 serve
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    Bp, Sp = 4, 64
    toks, traces = _parity_draws(cfg.vocab, Bp, Sp)
    qopts = dict(quantize="int8", fuse_projections=True, kv_dtype="int8")
    fp32_traces = {t: (dict(page_size=16, use_paged_kernel=True, **kw),
                       [np.asarray(p) for p in prompts], stagger, 8)
                   for t, (kw, prompts, stagger) in traces.items()}
    int8_traces = {t: ({**kw, "kv_dtype": "int8"}, *rest)
                   for t, (kw, *rest) in fp32_traces.items()}
    # the compressed decode path under tensor parallelism (prepared whole,
    # then sharded): int8 and packed-int4 factors with fused QKV and
    # up/gate over fp32 pages, and int8 factors over int8 pages
    qtp_opts = {"int8_fused": dict(quantize="int8", fuse_projections=True),
                "int4_fused": dict(quantize="int4", fuse_projections=True),
                "int8_fused_int8_kv": qopts}
    qtp_traces = {job: {t: ({**kw, **o}, *rest)
                        for t, (kw, *rest) in fp32_traces.items()}
                  for job, o in qtp_opts.items()}
    tp_dirs = {t: FT_DIR / f"tp{t}" for t in (1, TP)}
    for d in tp_dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    plain_kw, plain_prompts, _ = traces["plain"]
    p_snap = T.init_params(cfg32, seed=3, device=dev)
    eng = ContinuousBatchingEngine(cfg32, p_snap, page_size=16,
                                   use_paged_kernel=True, **plain_kw)
    tp1_done: dict = {}
    tp1_reqs = _ft_serve(eng, tp1_done, "the tp=1 serve to its snapshot",
                         trace=[(p, SamplingParams(max_new_tokens=8))
                                for p in plain_prompts], steps=3)
    eng.save_snapshot(tp_dirs[1])
    del eng, p_snap
    tp_jobs = {
        "fp32": {"cfg": cfg32, "seed": 3, "traces": fp32_traces,
                 "record": True},
        "int8_kv": {"cfg": cfg32, "seed": 3, "traces": int8_traces},
        **{job: {"cfg": cfg32, "seed": 3, "traces": tr,
                 "record": "int8_kv" not in job}
           for job, tr in qtp_traces.items()},
        "bf16": {"cfg": cfg, "seed": 0, "profile": True, "traces": {
            "serve": ({**SERVE_KW, "pool_bytes": fp_serve["pool_bytes"]},
                      _serve_prompts(cfg.vocab, 8, 32, 256, 0), 0, 32)}},
        # the tp = 1 snapshot restored at tp = 2; a tp = 2 snapshot saved
        "snapshot": {"cfg": cfg32, "seed": 3, "traces": {}, "snapshot": {
            "tp1_dir": str(tp_dirs[1]), "tp2_dir": str(tp_dirs[TP]),
            "engine": dict(page_size=16, use_paged_kernel=True,
                           **plain_kw),
            "prompts": [np.asarray(p) for p in plain_prompts],
            "steps": 3}},
    }
    tp_world = _start_world(tp_pool, _tp_rank, TP, tp_jobs)

    emit({"phase": "serve_profile", **_profile_serve(cfg, params)})
    emit({"phase": "serve_cow_window", **_cow_window(cfg, params)})

    # -- 3b. the compressed decode path: fused QKV, int8/int4 factors, int8
    # KV pages (qopts: above) -----------------------------------------------
    # quantization on the card is bitwise the CPU's
    p_cpu = tree_to(params, "cpu")
    for bits in (8, 4):
        on_card = prepare_decode_params(params, cfg, fuse=True, bits=bits)
        on_cpu = prepare_decode_params(p_cpu, cfg, fuse=True, bits=bits)
        flat_card, flat_cpu = [], []
        tree_map(flat_card.append, on_card)
        tree_map(flat_cpu.append, on_cpu)
        same = len(flat_card) == len(flat_cpu) and all(
            a.dtype == b.dtype and torch.equal(a.cpu(), b)
            for a, b in zip(flat_card, flat_cpu))
        emit({"phase": "quantized_load", "bits": bits,
              "tensors": len(flat_card), "bitwise_card_vs_cpu": same,
              "decode_weight_bytes": decode_weight_bytes(on_card),
              "decoder_weight_bytes": decode_weight_bytes(
                  on_card["decoder"])})
        require(same, f"int{bits} quantization differs card vs CPU")
        del on_card, on_cpu
    del p_cpu

    eng, reqs, counts, dt, out, prompt_toks = serve(
        cfg, params, 8, 32, 256, 32, seed=0,
        pool_bytes=fp_serve["pool_bytes"], **qopts)
    st_ = eng.stats
    emit({"phase": "serve_quantized", "model": "gpt2-medium",
          "options": qopts, "requests": len(reqs),
          "prompt_tokens": prompt_toks, "new_tokens": out, "seconds": dt,
          "tokens_per_s": out / dt,
          "tokens_per_s_fp_serve": fp_serve["tokens_per_s"],
          "decode_weight_bytes": decode_weight_bytes(eng.params),
          "decode_weight_bytes_fp_serve": fp_serve["decode_weight_bytes"],
          # the decoder layers alone: the factors int8 compresses, without
          # the embedding and head, which stay at the model's width
          "decoder_weight_bytes": decode_weight_bytes(eng.params["decoder"]),
          "decoder_weight_bytes_fp_serve": fp_serve["decoder_weight_bytes"],
          "pool_bytes": fp_serve["pool_bytes"],
          "pool_pages": eng.pool_host.n_pages - 1,
          "pool_pages_fp_serve": fp_serve["pool_pages"],
          "kv_dtype_fp_serve": fp_serve["kv_dtype"],
          "pool_pages_fp32_kv": fp_serve["pool_bytes"] // kv_page_bytes(
              cfg.n_layers, cfg.n_kv_heads, cfg.hd, 16, "fp32"),
          "steps": st_["mixed_steps"],
          "kernel_dispatches": st_["kernel_dispatches"],
          "dense_fallbacks": st_["dense_fallbacks"], "launches": counts,
          "graphs": _graphs_replayed(eng, "quantized serve")})
    require(counts["monarch_fused_q"] > 0
            and counts["paged_attention_span_q"] > 0,
            "the quantized serve launched no monarch_fused_q or int8 span "
            "kernel")
    require(counts["monarch_fused"] == 0
            and counts["paged_attention_span"] == 0 and counts["bdmm"] == 0,
            "the quantized serve launched a float-factor or float-page "
            "kernel")
    require(st_["dense_fallbacks"] == 0,
            "the quantized serve fell back to dense attention")
    for name in ("monarch_fused_q", "paged_attention_span_q",
                 "quantize_kv_write"):
        serve_counts[name] = counts[name]
    # the int8 write's host cost as the engine issued it before the step
    # became a graph, kernel and plain version (about 40 ops): one
    # decode-shaped call (8 rows x 1 token) into a pool of the serve's
    # size, synchronized wall clock per call
    n_pool = eng.pool_host.n_pages
    del eng
    wpages = torch.zeros((n_pool, 16, cfg.n_kv_heads, cfg.hd),
                         dtype=torch.int8, device=dev)
    wscales = torch.zeros((n_pool, cfg.n_kv_heads), device=dev)
    wphys = torch.arange(1, 9, device=dev)[:, None]
    woff = torch.full((8, 1), 5, device=dev)
    wrows = randn(8, 1, cfg.n_kv_heads, cfg.hd, dtype=bf16)
    wresc = torch.cat([wphys, wphys + 8], dim=1)
    write_ms = {}
    for wname, fn in (("kernel", KW.quantize_kv_write),
                      ("plain", quantize_kv_write)):
        for _ in range(5):
            fn(wpages, wscales, wphys, woff, wrows, rescale_phys=wresc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn(wpages, wscales, wphys, woff, wrows, rescale_phys=wresc)
        torch.cuda.synchronize()
        write_ms[wname] = (time.perf_counter() - t0) / 50 * 1e3
    del wpages
    prof_q = _profile_serve(cfg, params, **qopts)
    emit({"phase": "serve_profile_quantized", "options": qopts,
          "quantize_kv_write_wall_ms_per_call": write_ms["kernel"],
          "quantize_kv_write_wall_ms_per_step": write_ms["kernel"] * 2
          * cfg.n_layers,
          "quantize_kv_write_plain_wall_ms_per_call": write_ms["plain"],
          **prof_q})
    kv_writes_each_step(prof_q, "quantized", cfg.n_layers)

    eng, reqs, counts, dt, out, _ = serve(
        cfg, params, 4, 32, 64, 8, seed=2,
        **{**qopts, "quantize": "int4"})
    emit({"phase": "serve_int4", "requests": len(reqs), "new_tokens": out,
          "seconds": dt, "tokens_per_s": out / dt,
          "decode_weight_bytes": decode_weight_bytes(eng.params),
          "decoder_weight_bytes": decode_weight_bytes(eng.params["decoder"]),
          "steps": eng.stats["mixed_steps"],
          "dense_fallbacks": eng.stats["dense_fallbacks"],
          "launches": counts,
          "graphs": _graphs_replayed(eng, "int4 serve", compare=False)})
    require(counts["monarch_fused_q"] > 0 and counts["monarch_fused"] == 0
            and counts["paged_attention_span_q"] > 0
            and eng.stats["dense_fallbacks"] == 0,
            "the int4 serve must run monarch_fused_q and the int8 span "
            "kernel only")
    del eng, params

    cfg_st = dataclasses.replace(gpt2, monarch=dataclasses.replace(
        gpt2.monarch, backend="pallas", nblocks=128))
    params = T.init_params(cfg_st, seed=0, device=dev)
    eng, reqs, counts, dt, out, prompt_toks = serve(cfg_st, params, 4, 32, 64,
                                                    8, seed=2)
    emit({"phase": "serve_staged", "model": "gpt2-medium nblocks=128",
          "requests": len(reqs), "new_tokens": out, "seconds": dt,
          "tokens_per_s": out / dt, "steps": eng.stats["mixed_steps"],
          "dense_fallbacks": eng.stats["dense_fallbacks"],
          "launches": counts,
          "graphs": _graphs_replayed(eng, "staged serve", compare=False)})
    require(counts["bdmm"] > 0 and counts["monarch_fused"] == 0,
            "the nblocks=128 serve must take the staged bdmm branch only")
    require(counts["paged_attention_span"] > 0,
            "staged serve launched no paged_attention_span")
    serve_counts["bdmm"] = counts["bdmm"]
    del eng
    emit({"phase": "serve_profile_staged",
          **_profile_serve(cfg_st, params, watch=("bdmm",))})
    eng, reqs, counts, dt, out, _ = serve(cfg_st, params, 4, 32, 64, 8,
                                          seed=2, **qopts)
    emit({"phase": "serve_staged_quantized",
          "model": "gpt2-medium nblocks=128", "options": qopts,
          "requests": len(reqs), "new_tokens": out, "seconds": dt,
          "tokens_per_s": out / dt, "steps": eng.stats["mixed_steps"],
          "dense_fallbacks": eng.stats["dense_fallbacks"],
          "launches": counts,
          "graphs": _graphs_replayed(eng, "staged int8 serve",
                                    compare=False)})
    require(counts["bdmm_q"] > 0 and counts["monarch_fused_q"] == 0
            and counts["monarch_fused"] == 0 and counts["bdmm"] == 0,
            "the nblocks=128 int8 serve must take the staged bdmm_q branch "
            "only")
    require(counts["paged_attention_span_q"] > 0
            and eng.stats["dense_fallbacks"] == 0,
            "the nblocks=128 int8 serve must run the int8 span kernel")
    serve_counts["bdmm_q"] = counts["bdmm_q"]
    del eng
    prof_q = _profile_serve(cfg_st, params, watch=("bdmm",), **qopts)
    emit({"phase": "serve_profile_staged_quantized", "options": qopts,
          **prof_q})
    kv_writes_each_step(prof_q, "staged int8", cfg.n_layers)
    del params
    phase_done("3 serve")

    # -- 3c. nemotron-4-15b at full width: the card's first GQA serve -------
    # 32 layers, d 6144, 48 query heads over 8 KV heads at hd 128, d_ff
    # 24576 (squared ReLU), vocab 256000, untied embeddings (12.6 GB of
    # fp32 tables), published bf16 activations; Monarch paper policy: q, k,
    # v, o fused (B1), w1 and w2 staged (B2).  First B3/B6 at the serve's
    # decode call set (B = 8, H = 48, KV = 8, hd 128, page 16), each
    # against its plain version, B6 torch.equal to B3 on dequantized
    # pages, with SDPA on gathered pages (enable_gqa) as the yardstick
    nemo = get_config("nemotron-4-15b")
    cfg_n = dataclasses.replace(nemo, monarch=dataclasses.replace(
        nemo.monarch, backend="pallas"))
    Hn, KVn, hdn = cfg_n.n_heads, cfg_n.n_kv_heads, cfg_n.hd
    S, starts, spans = cases["decode"]
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    sl = torch.tensor(spans, dtype=torch.int32, device=dev)
    kn32, vn32 = randn(P, pg, KVn, hdn), randn(P, pg, KVn, hdn)
    (knq, kns), (vnq, vns) = quantize_kv_page(kn32), quantize_kv_page(vn32)
    knd, vnd = dequantize_kv_pages(knq, kns), dequantize_kv_pages(vnq, vns)
    n_pages, n_pairs = span_work(starts, spans, GLOBAL_WINDOW)
    T_all = MP * pg
    tpos = torch.arange(T_all, device=dev)[None, None, :]
    gmask = (tpos <= st.long()[:, None, None])[:, None]
    for dt in (f32, bf16):
        dn = dn_of(dt)
        q = randn(B, S, Hn, hdn, dtype=dt)
        for quant in (False, True):
            kp, vp = (knq, vnq) if quant else (kn32.to(dt), vn32.to(dt))
            sc = dict(k_scales=kns, v_scales=vns) if quant else {}
            args = (q, kp, vp, pt, st, sl, GLOBAL_WINDOW)
            out = paged_attention_span(*args, **sc)
            err, ok = close(out, paged_attention_span_plain(
                *args, sc.get("k_scales"), sc.get("v_scales")), dn)
            again = torch.equal(out, paged_attention_span(*args, **sc))
            same = (not quant) or torch.equal(out, paged_attention_span(
                q, knd, vnd, pt, st, sl, GLOBAL_WINDOW))
            name = "paged_attention_span" + ("_q" if quant else "")
            errs[name] = max(errs[name], err)
            kd_, vd_ = (knd.to(dt), vnd.to(dt)) if quant else (kp, vp)
            kk = kd_[pt.long()].reshape(B, T_all, KVn, hdn).transpose(1, 2)
            vv = vd_[pt.long()].reshape(B, T_all, KVn, hdn).transpose(1, 2)
            qq = q.transpose(1, 2)
            eb, pb = q.element_size(), kp.element_size()
            bms, by = bound_ms(
                2 * B * S * Hn * hdn * eb + 2 * n_pages * pg * KVn * hdn * pb
                + (2 * n_pages * KVn * 4 if quant else 0),
                4 * hdn * Hn * n_pairs, all_bf16=dt == bf16 and not quant)
            line = {"phase": "kernel", "kernel": name,
                    "call_set": "nemotron-4-15b decode (GQA)", "S": S,
                    "window": GLOBAL_WINDOW, "q_dtype": dn,
                    "page_dtype": "int8" if quant else dn, "B": B,
                    "H": Hn, "KV": KVn, "hd": hdn, "page": pg,
                    "pages_read": n_pages, "max_abs_err": err,
                    "tol": TOL[dn], "deterministic": again,
                    **({"bitwise_vs_paged_attention_span": same}
                       if quant else {}),
                    "launch": {**span_geometry(S, hdn, pg, MP)._asdict(),
                               "blocks": B * Hn * span_geometry(
                                   S, hdn, pg, MP).blocks},
                    **timings(
                        kernel=lambda: paged_attention_span(*args, **sc),
                        plain=lambda: paged_attention_span_plain(
                            *args, sc.get("k_scales"), sc.get("v_scales")),
                        library=lambda: F.scaled_dot_product_attention(
                            qq, kk, vv, attn_mask=gmask, enable_gqa=True)),
                    "bound_ms": bms, "bound_by": by}
            emit(line)
            require(ok and again and same,
                    f"{name} GQA decode {dn}: err {err}, deterministic "
                    f"{again}, bitwise {same}")
    del kn32, vn32, knq, vnq, knd, vnd

    # the float serve, its replays against eager steps and its profiled
    # window; then the int8 serve (int8 factors, K and V fused, int8 KV
    # pages: B4, B5, B6 and X2) on the same pool bytes, and its window
    params = T.init_params(cfg_n, seed=0, device=dev)
    eng, reqs, counts, dt, out, prompt_toks = serve(
        cfg_n, params, NEMOTRON_REQUESTS, 32, 256, 32, seed=0)
    st_ = eng.stats
    n_pool_bytes = eng.pool_host.stats().pool_bytes
    emit({"phase": "serve_nemotron", "model": "nemotron-4-15b",
          "dtype": cfg_n.dtype, "layers": cfg_n.n_layers,
          "heads": [Hn, KVn, hdn], "requests": len(reqs),
          "prompt_tokens": prompt_toks, "new_tokens": out, "seconds": dt,
          "tokens_per_s": out / dt, "steps": st_["mixed_steps"],
          "kernel_dispatches": st_["kernel_dispatches"],
          "dense_fallbacks": st_["dense_fallbacks"], "launches": counts,
          "kv_dtype": eng.kv_dtype, "pool_pages": eng.pool_host.n_pages - 1,
          "pool_bytes": n_pool_bytes,
          "decode_weight_bytes": decode_weight_bytes(eng.params),
          "decoder_weight_bytes": decode_weight_bytes(
              eng.params["decoder"]),
          "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
          "graphs": _graphs_replayed(eng, "nemotron serve")})
    require(counts["monarch_fused"] > 0 and counts["bdmm"] > 0
            and counts["paged_attention_span"] > 0
            and counts["sample_tokens"] > 0,
            f"the nemotron serve must run B1, B2, B3 and X3: {counts}")
    require(st_["dense_fallbacks"] == 0,
            "the nemotron serve fell back to dense attention")
    del eng
    prof_n = _profile_serve(cfg_n, params, watch=("bdmm", "paged_span"))
    emit({"phase": "serve_profile_nemotron", **prof_n})
    for wname, w in prof_n.items():
        seen = w["launches_per_step_profiled_vs_counted"]
        require(all(seen[k][0] > 0 for k in ("monarch_fused_kernel", "bdmm_",
                                             "paged_span_kernel")),
                f"nemotron {wname} window: the profiler must show B1, B2 "
                f"and B3: {seen}")
    eng, reqs, counts, dt, out, _ = serve(
        cfg_n, params, NEMOTRON_REQUESTS, 32, 256, 32, seed=0,
        pool_bytes=n_pool_bytes, **qopts)
    attn_keys = sorted(eng.params["decoder"]["layers"]["attn"])
    emit({"phase": "serve_nemotron_quantized", "model": "nemotron-4-15b",
          "options": qopts, "requests": len(reqs), "new_tokens": out,
          "seconds": dt, "tokens_per_s": out / dt,
          "steps": eng.stats["mixed_steps"],
          "dense_fallbacks": eng.stats["dense_fallbacks"],
          "fused_projections": attn_keys,
          "pool_pages": eng.pool_host.n_pages - 1,
          "decode_weight_bytes": decode_weight_bytes(eng.params),
          "decoder_weight_bytes": decode_weight_bytes(
              eng.params["decoder"]),
          "launches": counts,
          "graphs": _graphs_replayed(eng, "nemotron int8 serve")})
    require("wkv" in attn_keys and "wq" in attn_keys
            and "wqkv" not in attn_keys,
            f"GQA fuses K and V only: {attn_keys}")
    require(all(counts[k] > 0 for k in ("monarch_fused_q", "bdmm_q",
                                        "paged_attention_span_q",
                                        "quantize_kv_write"))
            and counts["monarch_fused"] == 0 and counts["bdmm"] == 0
            and counts["paged_attention_span"] == 0
            and eng.stats["dense_fallbacks"] == 0,
            f"the nemotron int8 serve must run B4, B5, B6 and X2 only: "
            f"{counts}")
    del eng
    prof_nq = _profile_serve(cfg_n, params, watch=("bdmm", "paged_span"),
                             **qopts)
    emit({"phase": "serve_profile_nemotron_quantized", "options": qopts,
          **prof_nq})
    kv_writes_each_step(prof_nq, "nemotron int8", cfg_n.n_layers)
    for wname, w in prof_nq.items():
        seen = w["launches_per_step_profiled_vs_counted"]
        require(all(seen[k][0] > 0 for k in ("monarch_fused_kernel", "bdmm_",
                                             "paged_span_kernel",
                                             "kv_store_kernel")),
                f"nemotron int8 {wname} window: the profiler must show B4, "
                f"B5, B6 and X2: {seen}")
    _ring_nemotron(cfg_n, params, dev)
    del params
    torch.cuda.empty_cache()
    phase_done("3c nemotron serve")

    # -- 3d. the paper's pipeline: D2S at full width on the card against the
    # CPU, the converted model served, one nemotron-4-15b layer projected,
    # the CIM emulation of a mapped pair against B1, the two cost models'
    # calibration and a budgeted serve, and the quickstart -----------------
    import contextlib
    import io
    import runpy

    from repro_torch.cim import functional as CF
    from repro_torch.cim import mapping as CM
    from repro_torch.cim import scheduling as CS
    from repro_torch.core.d2s import convert_tree, project_to_monarch
    from repro_torch.core.monarch import MonarchDims, stage_specs
    from repro_torch.serving import (CIMCostModel, HBMCostModel,
                                     SamplingParams, SchedulerConfig)

    def d2s_select(path, leaf) -> bool:
        return any(s in path for s in D2S_MATMULS)

    def d2s_both(params, what: str, every: int = 1, select=d2s_select):
        """``convert_tree`` over ``params`` on the card (timed; a leaf's
        seconds run from its select call to the next leaf's) and on the CPU
        from the same dense tensors: with ``every`` > 1 the CPU projects
        only every ``every``-th row of (p x s) slices (ki) of each matrix,
        a Monarch matrix of its own, against the card's factors of those
        rows.  Every matrix's ``monarch_to_dense`` card vs CPU (Frobenius
        distance relative to ||M||) and the worst (p x s) slice (relative
        to the slice's own norm).  Returns the card's converted tree.  With
        ``every`` 1 the CPU converts on a worker thread while the card
        does (each side's seconds are its own, the other beside it)."""
        import concurrent.futures

        stamps: list = []

        def timed_select(path, leaf):
            torch.cuda.synchronize()
            stamps.append((path, time.perf_counter()))
            return select(path, leaf)

        def on_cpu(tree):
            t0 = time.perf_counter()
            return convert_tree(tree, select), time.perf_counter() - t0

        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            if every == 1:
                cpu_side = pool.submit(on_cpu, tree_to(params, "cpu"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            conv, reps = convert_tree(params, timed_select)
            torch.cuda.synchronize()
            t_card = time.perf_counter() - t0
            stamps.append(("", time.perf_counter()))
            if every == 1:
                (conv_cpu, reps_cpu), t_cpu = cpu_side.result()
        names = {r.name for r in reps}
        per_leaf = {p: stamps[i + 1][1] - t
                    for i, (p, t) in enumerate(stamps[:-1]) if p in names}
        if every == 1:
            require([(r.name, r.dims) for r in reps]
                    == [(r.name, r.dims) for r in reps_cpu],
                    f"{what}: card and CPU converted other matrices")
            for r, rc in zip(reps, reps_cpu):
                require(abs(r.rel_error - rc.rel_error) <= D2S_REL_TOL,
                        f"{what} {r.name}: projection errors differ card "
                        f"vs CPU: {r.rel_error} / {rc.rel_error}")
        else:
            t0 = time.perf_counter()
            conv_cpu = {}
            for r in reps:
                w = _leaf(params, r.name).cpu()
                lead, (k, q, p) = w.shape[:-2], r.dims.l_shape
                rows = w.reshape(*lead, k, p, r.dout)[..., ::every, :, :]
                sub = MonarchDims(rows.shape[-3] * p, r.dout,
                                  rows.shape[-3], q)
                Lc, Rc = project_to_monarch(
                    rows.reshape(*lead, sub.din, r.dout), sub)
                conv_cpu[r.name] = {"L": Lc, "R": Rc}
            t_cpu = time.perf_counter() - t0
        worst_m, worst_s = {"rel": -1.0}, {"rel_to_slice": -1.0}
        n_mat = dense = sparse = 0
        for r in reps:
            fa = _leaf(conv, r.name)
            fb = (_leaf(conv_cpu, r.name) if every == 1
                  else conv_cpu[r.name])
            n = int(np.prod(fa["L"].shape[:-3]))
            n_mat += n
            dense += n * r.dense_params
            sparse += n * r.sparse_params
            La, Ra = fa["L"][..., ::every, :, :], fa["R"][..., ::every]
            m_a = monarch_to_dense(La, Ra).double()
            m_b = monarch_to_dense(fb["L"].to(dev), fb["R"].to(dev)).double()
            k, q, p, s = La.shape[-3], r.dims.q, r.dims.p, r.dims.s
            d4 = (m_a - m_b).reshape(n, k, p, q, s)
            m4 = m_b.reshape(n, k, p, q, s)
            per = d4.square().sum((1, 2, 3, 4)).sqrt() / m4.square().sum(
                (1, 2, 3, 4)).sqrt()
            i = int(per.argmax())
            if float(per[i]) > worst_m["rel"]:
                worst_m = {"matrix": r.name, "layer": i, "rel": float(per[i])}
            sl = d4.square().sum((2, 4)).sqrt() / m4.square().sum(
                (2, 4)).sqrt().clamp(min=1e-30)                 # (n, k, q)
            j = int(sl.argmax())
            if float(sl.max()) > worst_s["rel_to_slice"]:
                li, ki, qi = np.unravel_index(j, tuple(sl.shape))
                worst_s = {"matrix": r.name, "layer": int(li),
                           "slice": [int(ki) * every, int(qi)],
                           "p_s": [p, s], "rel_to_slice": float(sl.max())}
            del m_a, m_b, d4, m4
        worst_err = max(reps, key=lambda r: r.rel_error)
        emit({"phase": "d2s", "model": what, "matmuls": n_mat,
              "leaves": len(reps), "dense_params": dense,
              "sparse_params": sparse, "compression": dense / sparse,
              "worst_rel_error": {"matrix": worst_err.name,
                                  "rel_error": worst_err.rel_error},
              "card_seconds": t_card, "cpu_seconds": t_cpu,
              "cpu_slice_rows": f"every {every}",
              "card_seconds_per_leaf": per_leaf,
              "slices_per_leaf": {r.name: [r.dims.k * r.dims.q, r.dims.p,
                                           r.dims.s] for r in reps},
              "card_vs_cpu": {"worst_matrix": worst_m,
                              "worst_slice": worst_s},
              "rel_tol": D2S_REL_TOL})
        require(worst_m["rel"] <= D2S_REL_TOL,
                f"{what}: D2S card vs CPU differ: {worst_m}")
        return conv

    # D2S of gpt2-medium:dense at full width (fp32) and D2S_LAYERS of its
    # 24 layers, card against CPU
    cfg_d = dataclasses.replace(get_config("gpt2-medium:dense"),
                                dtype="float32", n_layers=D2S_LAYERS)
    conv = d2s_both(T.init_params(cfg_d, seed=0, device=dev),
                    "gpt2-medium:dense")
    torch.cuda.empty_cache()

    # the converted model served on the card (B1, B3, X3, graphs) with the
    # HBM cost model's calibration beside it; again under a step-latency
    # budget of the median decode step that serve measured, on the card
    # and on the CPU from the card's factors: the same greedy tokens and
    # the same prefill chunks; and once more on the card only with that
    # budget in the model's own ns (over the calibration's scale)
    cfg_dc = dataclasses.replace(cfg_d, monarch=dataclasses.replace(
        cfg_d.monarch, backend="pallas"))
    hbm_conv = HBMCostModel.from_params(cfg_dc, conv, bandwidth_gbps=HBM_GBPS,
                                        compute_gflops=BF16_GFLOPS)

    def d2s_serve(budget: Optional[float] = None, **engine_kw):
        kw = dict(cost_model=hbm_conv, scheduler_cfg=SchedulerConfig(
            step_latency_budget_ns=budget), **engine_kw)
        if engine_kw.get("device") == "cpu":
            eng = ContinuousBatchingEngine(cfg_dc, conv, **{**SERVE_KW, **kw})
            reqs = [eng.add_request(p, SamplingParams(max_new_tokens=32))
                    for p in _serve_prompts(cfg_dc.vocab, 8, 32, 256, 0)]
            t0 = time.perf_counter()
            eng.run()
            dt, counts = time.perf_counter() - t0, None
        else:
            eng, reqs, counts, dt, _, _ = serve(cfg_dc, conv, 8, 32, 256, 32,
                                                seed=0, **kw)
        out = [list(r.output_tokens) for r in reqs]
        return eng, out, counts, {
            "step_latency_budget_ns": budget, "seconds": dt,
            "tokens_per_s": sum(map(len, out)) / dt,
            "steps": eng.calibration.n, "chunks": _chunks(eng)}

    eng, _, counts, plain = d2s_serve()
    cal_conv = _calibration(eng)
    emit({"phase": "serve_d2s", "model": "gpt2-medium:dense D2S",
          "dtype": cfg_dc.dtype, "requests": 8, "new_tokens": 8 * 32,
          **plain, "dense_fallbacks": eng.stats["dense_fallbacks"],
          "launches": counts, "graphs": _graphs_replayed(eng, "d2s serve"),
          "calibration_hbm": cal_conv})
    require(counts["monarch_fused"] > 0 and counts["paged_attention_span"] > 0
            and counts["sample_tokens"] > 0
            and eng.stats["dense_fallbacks"] == 0,
            f"the converted serve must run B1, B3 and X3: {counts}")
    del eng
    budget = cal_conv["median_decode_step_ns"]
    eng, card_tokens, _, card = d2s_serve(budget)
    del eng
    eng_c, cpu_tokens, _, cpu = d2s_serve(budget, device="cpu")
    emit({"phase": "serve_d2s_budgeted", "budget": "median_decode_step",
          **card, "chunks_as_unbudgeted": card["chunks"] == plain["chunks"],
          "cpu_seconds": cpu["seconds"], "cpu_steps": cpu["steps"],
          "cpu_chunks_identical": cpu["chunks"] == card["chunks"],
          "cpu_tokens_identical": cpu_tokens == card_tokens})
    require(cpu_tokens == card_tokens,
            "the converted model's tokens differ card vs CPU")
    require(cpu["chunks"] == card["chunks"] and cpu["steps"] == card["steps"],
            "the budgeted serve: the CPU engine planned other chunks")
    del eng_c
    eng, _, _, scaled = d2s_serve(budget / cal_conv["scale"])
    emit({"phase": "serve_d2s_budgeted",
          "budget": "median_decode_step_over_scale", **scaled,
          "chunks_as_unbudgeted": scaled["chunks"] == plain["chunks"]})
    del eng
    phase_done("3d D2S and the converted serve")

    # the CIM mapping of the converted layer 0 wq pair (SparseMap and
    # DenseMap), its arrays programmed and the schedule executed in float64
    # on the card (cim/functional.py), against B1's fp32 output on 8 rows
    wq = _leaf(conv, "['decoder']['layers']['attn']['wq']['w']")
    L0, R0 = wq["L"][0].contiguous(), wq["R"][0].contiguous()
    dims = make_dims(L0.shape[0] * L0.shape[2], R0.shape[0] * R0.shape[1])
    x8 = randn(8, dims.din)
    y_b1 = monarch_fused(x8, L0, R0)
    weights = {"wq/L": torch.block_diag(*L0.double().transpose(1, 2)),
               "wq/R": torch.block_diag(*R0.double().transpose(1, 2))}
    pair = CM.MonarchPair(*stage_specs(dims, name="wq"), name="wq")
    for strat, mp in (("sparse", CM.map_sparse([pair.L, pair.R], 256)),
                      ("dense", CM.map_dense_pack([pair], 256))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arrays = CF.program_arrays(mp, weights)
        cyc_l = CS.schedule_matmul(mp, "wq/L")
        cyc_r = CS.schedule_matmul(mp, "wq/R")
        ys = []
        for row in x8.double():
            u = CF.execute_matmul(mp, arrays, cyc_l, {"wq/L": row})["wq/L"]
            ys.append(CF.execute_matmul(
                mp, arrays, cyc_r,
                {"wq/R": u.reshape(dims.k, dims.q).T.reshape(-1)})["wq/R"])
        y_cim = torch.stack(ys)
        torch.cuda.synchronize()
        err, ok = close(y_b1, y_cim, "float32")
        exact = float((y_cim - x8.double() @ monarch_to_dense(
            L0.double(), R0.double())).abs().max())
        emit({"phase": "cim_vs_b1", "matmul": "gpt2-medium layer 0 wq (D2S)",
              "strategy": strat, "arrays": mp.n_arrays,
              "utilization": mp.utilization,
              "cycles": [len(cyc_l), len(cyc_r)], "rows": 8,
              "device": str(arrays[0].device), "max_abs_err": err,
              "tol": TOL["float32"], "vs_float64_product": exact,
              "seconds": time.perf_counter() - t0})
        require(ok and arrays[0].is_cuda,
                f"CIM {strat} emulation vs B1: err {err}")
    del conv, wq, L0, R0, weights, arrays
    torch.cuda.empty_cache()

    # one nemotron-4-15b layer at full width (dense, fp32: the whole model
    # would be 60 GB), its D2S_NEMOTRON_MATMULS projected on the card; the
    # CPU checks every D2S_NEMOTRON_CPU_EVERY-th row of slices
    cfg_nd = dataclasses.replace(get_config("nemotron-4-15b:dense"),
                                 n_layers=1, dtype="float32")
    gen_nd = torch.Generator(device=dev)
    gen_nd.manual_seed(0)
    d2s_both({"decoder": T.decoder_stack_init(gen_nd, cfg_nd)},
             "nemotron-4-15b:dense, 1 layer, "
             + "/".join(D2S_NEMOTRON_MATMULS),
             every=D2S_NEMOTRON_CPU_EVERY,
             select=lambda path, leaf: any(f"['{m}']" in path
                                           for m in D2S_NEMOTRON_MATMULS))
    torch.cuda.empty_cache()

    # the float serves of phases 3 and 3c priced by each cost model: the
    # engine's calibration (measured over predicted ns a step)
    for c, n_req in ((cfg, 8), (cfg_n, NEMOTRON_REQUESTS)):
        params = T.init_params(c, seed=0, device=dev)
        for mname, cm in (
                ("hbm", HBMCostModel.from_params(
                    c, params, bandwidth_gbps=HBM_GBPS,
                    compute_gflops=BF16_GFLOPS)),
                ("cim", CIMCostModel(c, strategy="sparse"))):
            eng, reqs, counts, dt, out, _ = serve(c, params, n_req, 32, 256,
                                                  32, seed=0, cost_model=cm)
            cal = _calibration(eng)
            emit({"phase": "calibration", "model": c.name, "dtype": c.dtype,
                  "cost_model": mname, "tokens_per_s": out / dt,
                  "steps": eng.stats["mixed_steps"], **cal})
            require(cal["n"] > 0 and cal["decode_steps"] > 0
                    and math.isfinite(cal["scale"]) and cal["scale"] > 0,
                    f"{c.name} {mname}: no calibration: {cal}")
            del eng
        del params
        torch.cuda.empty_cache()

    # the quickstart, as ``python -m repro_torch.examples.quickstart`` runs
    # it, on the card
    buf = io.StringIO()
    argv, sys.argv = sys.argv, ["quickstart"]
    reset_launches()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_module("repro_torch.examples.quickstart",
                             run_name="__main__", alter_sys=True)
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = argv
    lines = buf.getvalue().strip().splitlines()
    emit({"phase": "quickstart", "exit": code, "last": lines[-6:],
          "launches": {k: v for k, v in launches().items() if v}})
    require(code == 0 and lines[-1] == "quickstart OK"
            and launches()["monarch_fused"] > 0,
            "the quickstart did not end with 'quickstart OK' through B1")

    # the D2S conversion example, as ``python -m
    # repro_torch.examples.d2s_convert`` runs it, on the card
    buf = io.StringIO()
    argv, sys.argv = sys.argv, ["d2s_convert"]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_module("repro_torch.examples.d2s_convert",
                             run_name="__main__", alter_sys=True)
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = argv
    lines = buf.getvalue().strip().splitlines()
    emit({"phase": "d2s_convert_example", "exit": code, "lines": lines})
    require(code == 0 and lines[-1] == "d2s_convert OK",
            "the d2s_convert example did not end with 'd2s_convert OK'")
    phase_done("3d CIM, calibration and quickstart")

    # -- 3e. fault-tolerant serving (3j's and 5e's worlds start beside
    # it) ------------------------------------------------------------------
    tm_world = _tm_start(worlds)
    tpf_world = _tpf_start(worlds)
    _phase_ft(dev)
    phase_done("3e fault-tolerant serving")

    # -- 3f. the ring cache and the legacy ServeEngine (gpt2-medium at full
    # width), then the serve_decode example's two engines ----------------
    _phase_ring(dev)
    torch.cuda.empty_cache()
    _example_runs(dev)
    phase_done("3f ring cache and ServeEngine")

    # -- 3g. mixture of experts and sandwich norms: qwen2-moe-a2.7b and
    # granite-moe-1b-a400m at full width and depth (the experts' B1/B4 one
    # launch a projection), gemma2-27b at full width and depth, each card
    # vs CPU at 2 layers --------------------------------------------------
    _phase_moe(dev, serve_counts)
    torch.cuda.empty_cache()
    phase_done("3g mixture of experts and sandwich norms")

    # -- 3h. the Mamba2 and Zamba2 hybrid stacks through the legacy
    # ServeEngine, the encoder-decoder's serving steps, the vision
    # frontend's prefill and text serve, each card vs CPU; the sink
    # writes' determinism (§C 4); the serve_decode example at mamba2 ----
    _phase_families(dev)
    phase_done("3h Mamba2, hybrid, encoder-decoder and vision")

    # -- 3i. training: card vs CPU at 2 layers (gpt2-medium, granite-moe,
    # mamba2), gpt2-medium trained at full width and depth and resumed from
    # its checkpoint, the kernels' refusal of autograd ----------------------
    t0 = time.perf_counter()
    concurrent.futures.wait([tm_world[1], tpf_world[1], tp_world])
    emit({"phase": "worlds_joined", "waited_seconds": time.perf_counter() - t0,
          "note": "this process waited for the gloo worlds of phases 3j, "
                  "5c and 5e that ran beside phases 3-3h"})
    train_run = _phase_train(dev)
    torch.cuda.empty_cache()
    phase_done("3i training")

    # -- 3j. training under a (data 2 x model 2) mesh: four gloo ranks on
    # the card held to the single-process step (gpt2-medium fp32 at full
    # width and depth, granite-moe-1b-a400m fp32 at 2 layers), gpt2-medium
    # bf16 as a reading, granite's mesh checkpoint resumed by one process
    mesh_run = _phase_train_mesh(dev, tm_world)
    torch.cuda.empty_cache()
    phase_done("3j training under the mesh")

    # -- 4. card vs CPU at full width, fp32 ---------------------------------
    # cfg32, Bp, Sp and the seed-3 draws ``toks``: phase 3's
    p_gpu = T.init_params(cfg32, seed=3, device=dev)
    p_cpu = tree_to(p_gpu, "cpu")
    mpp = 8
    table = (1 + np.arange(Bp * mpp, dtype=np.int32)).reshape(Bp, mpp)
    spans_np = np.array([64, 40, 17, 1], np.int32)

    def mixed_step_on(params, d, kv_dtype=None, c=None, record=None):
        """One full-width mixed step of model ``c`` (default: cfg32) on
        device ``d``: the logits and the pool, both on the CPU.  With
        ``record``, the step runs layer by layer (the same operations,
        :func:`_layered_mixed_step`) and hands each stage to it."""
        c = c or cfg32
        pool = T.init_paged_pool(c, 1 + Bp * mpp, 16, kv_dtype=kv_dtype,
                                 device=d)
        args = (params, torch.from_numpy(toks).to(d),
                torch.zeros(Bp, dtype=torch.int32, device=d),
                torch.from_numpy(spans_np).to(d),
                torch.from_numpy(table).to(d))
        if record is None:
            lg, _ = T.paged_mixed_step(*args, pool, c)
        else:
            lg = _layered_mixed_step(*args, pool, c, record)
        return lg[:, :c.vocab].float().cpu(), tree_to(pool, "cpu")

    def logit_err(a, b) -> tuple[float, float]:
        diff = (a - b).abs()
        return float(diff.max() / b.abs().max()), float(diff.max())

    def mixed_step_both(params_by_device, kv_dtype=None, c=None):
        """One full-width mixed step on the card and on the CPU: relative
        and absolute logit error, and both pools (card's first)."""
        lg_card, pool_card = mixed_step_on(params_by_device["cuda"], dev,
                                           kv_dtype, c)
        lg_cpu, pool_cpu = mixed_step_on(params_by_device["cpu"],
                                         torch.device("cpu"), kv_dtype, c)
        require(bool(torch.isfinite(lg_card).all()), "non-finite logits")
        return (*logit_err(lg_card, lg_cpu), (pool_card, pool_cpu), lg_cpu)

    rel, abs_err, _, lg_cpu = mixed_step_both({"cuda": p_gpu, "cpu": p_cpu})

    def graphed_step_rel(params, n: int = 5) -> list:
        """The same step captured as one CUDA graph and replayed ``n``
        times, each on a zeroed pool: each replay's relative logit
        difference from the CPU."""
        pool = T.init_paged_pool(cfg32, 1 + Bp * mpp, 16, device=dev)
        ins = [torch.from_numpy(toks).to(dev),
               torch.zeros(Bp, dtype=torch.int32, device=dev),
               torch.from_numpy(spans_np).to(dev),
               torch.from_numpy(table).to(dev)]
        from repro_torch.serving.step_graphs import CudaStepGraph

        T.paged_mixed_step(params, *ins, pool, cfg32)   # the first: eager
        graph = CudaStepGraph(torch.cuda.graph_pool_handle())
        lg, _ = graph.capture(
            lambda: T.paged_mixed_step(params, *ins, pool, cfg32))
        leaves: list = []
        tree_map(leaves.append, pool)
        rels = []
        for _ in range(n):
            for leaf in leaves:
                leaf.zero_()
            graph.replay()
            rels.append(logit_err(lg[:, :cfg.vocab].float().cpu(),
                                  lg_cpu)[0])
        return rels

    graphed = graphed_step_rel(p_gpu)

    class Float64(torch.overrides.TorchFunctionMode):
        """Every float32 that a torch function is asked for, as a dtype
        argument or by ``.float()``, made float64."""

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.float:
                func = torch.Tensor.double
            args = tuple(torch.float64 if a is torch.float32 else a
                         for a in args)
            kwargs = {k: torch.float64 if v is torch.float32 else v
                      for k, v in (kwargs or {}).items()}
            return func(*args, **kwargs)

    def fp64_witness(pc, c, record):
        """The same step on the CPU in float64 throughout (params, pool
        and every float32 on its path widened, :class:`Float64`), layer
        by layer.  Returns its logits: the card's and the fp32 CPU's
        distance from them says which side moved when the two disagree."""
        p64 = tree_map(lambda t: t.double() if t.is_floating_point()
                       else t, pc)
        produced: set = set()

        class Watch(torch.overrides.TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if isinstance(out, torch.Tensor):
                    produced.add(out.dtype)
                return out

        with Watch(), Float64():
            lg64, _ = mixed_step_on(p64, torch.device("cpu"), c=c,
                                    record=record)
        require(lg64.dtype == torch.float64
                and not produced & {torch.float32, torch.bfloat16,
                                    torch.float16},
                f"the float64 witness step made {sorted(map(str, produced))}")
        return lg64

    # what a reading above the limit would need to be traced to: the
    # weights, each side's logits, the host's CPU and the card's SMs
    cpuinfo = Path("/proc/cpuinfo")
    cpu_lines = (cpuinfo.read_text().splitlines() if cpuinfo.exists()
                 else [])
    cpu_flags = set(next((ln.split(":", 1)[1].split() for ln in cpu_lines
                          if ln.startswith("flags")), []))

    def parity_step(c, pg_, pc_, rel, abs_err, lg_cpu, **extra) -> dict:
        """Phase 4's parity line for model ``c``: the step's logits card vs
        CPU (``rel``, ``abs_err``, from the step as the engine runs it),
        each side's distance from the float64 step, and where the two
        part: the residual stream after the embedding and after each
        layer, the final norm and the LM head's input (the real positions
        only), and the logits, card vs CPU and each against float64; the
        first stage whose card-vs-CPU difference is more than twice the
        stage's before it; and the CPU's head on the card's head input
        against the card's logits (the unembedding alone: a matmul on
        both sides, in other algorithms)."""
        from repro_torch.models import layers as L

        def recorder(into: dict):
            def record(name, x):
                if x.shape[1] == Sp:   # (B, S, d): the real positions
                    real = (torch.arange(Sp, device=x.device)[None, :]
                            < torch.from_numpy(spans_np).to(x.device)[:, None])
                    x = x[real]
                into[name] = x.float().cpu()
            return record

        st_card, st_cpu, st_64 = {}, {}, {}
        lg_card = mixed_step_on(pg_, dev, c=c, record=recorder(st_card))[0]
        lg_card_direct = mixed_step_on(pg_, dev, c=c)[0]
        lg_cpu_l = mixed_step_on(pc_, torch.device("cpu"), c=c,
                                 record=recorder(st_cpu))[0]
        require(torch.equal(lg_card, lg_card_direct)
                and torch.equal(lg_cpu_l, lg_cpu),
                f"{c.name}: the layered step is not the engine's step")
        lg64 = fp64_witness(pc_, c, recorder(st_64))
        st_card["logits"], st_cpu["logits"], st_64["logits"] = (
            lg_card, lg_cpu, lg64)
        per_layer = _per_layer(st_card, st_cpu, st_64)
        head_cpu = L.unembed(pc_["embedding"], st_card["head_in"],
                             c)[:, 0, :c.vocab]
        line = {"phase": "parity_step", "model": c.name,
                "layers": c.n_layers, "max_abs_err": abs_err,
                "max_rel_err": rel, "rel_tol": PARITY_REL_TOL,
                "finite": True, **extra,
                "vs_fp64_cpu": {
                    "card_rel": logit_err(lg_card.double(), lg64)[0],
                    "cpu_fp32_rel": logit_err(lg_cpu.double(), lg64)[0]},
                "per_layer": per_layer,
                "lm_head": {
                    n: {k: per_layer[k][per_layer["stages"].index(s_)]
                        for k in ("card_vs_cpu", "card_vs_fp64",
                                  "cpu_vs_fp64")}
                    for n, s_ in (("input", "head_in"),
                                  ("output", "logits"))},
                "cpu_head_on_card_input_vs_card": _rel(lg_card, head_cpu),
                "sources": {
                    "weights_sum": _checksum(pg_),
                    "card_logits_sum": float(lg_card.double().sum()),
                    "cpu_logits_sum": float(lg_cpu.double().sum()),
                    "cpu": sorted({ln.split(":", 1)[1].strip()
                                   for ln in cpu_lines
                                   if ln.startswith(("vendor_id", "model\t",
                                                     "cpu family"))}),
                    "cpu_isa": sorted(f for f in cpu_flags
                                      if f.startswith(("avx512f",
                                                       "amx_tile"))),
                    "cpu_capability": torch.backends.cpu.get_cpu_capability(),
                    "cpu_threads": torch.get_num_threads(),
                    "sms": torch.cuda.get_device_properties(
                        0).multi_processor_count}}
        emit(line)
        require(rel <= PARITY_REL_TOL,
                f"{c.name}: card vs CPU logits differ: rel {rel}")
        return line

    def parity_ops(c, pg_, pc_) -> dict:
        """Layer 0 of model ``c``'s step (the engine's: B3 attention) op by
        op (:func:`_layer0_ops`), from the embedding of phase 4's tokens,
        on the card, on the CPU in fp32 and in float64 (real positions
        only): each op's output card vs CPU, and each side against
        float64; then each op alone, the card's own inputs run on the CPU
        in fp32 and in float64 against the card's output.  Names the first
        op where the card is more than twice as far from float64 as the
        CPU, in the step and alone."""
        from repro_torch.models import layers as L

        ff = T.layer_params(pc_["decoder"]["layers"], 0)["ffn"]
        require(c.ffn_type == "relu2" and not c.qk_norm
                and not any("b" in w for w in ff.values())
                and not any(fused_fits(tuple(w["L"].shape),
                                       tuple(w["R"].shape))
                            for w in ff.values()),
                f"{c.name}: the op breakdown is written for a biasless "
                "squared-ReLU stack with a staged FFN pair")
        win = T.layer_windows(c)[0]
        real = (torch.arange(Sp)[None, :]
                < torch.from_numpy(spans_np)[:, None])

        def rows(t):
            t = t.detach().cpu().double()
            return t.reshape(Bp, Sp, -1)[real]

        def to(tree, d, double=False):
            if isinstance(tree, dict):
                return {k: to(v, d, double) for k, v in tree.items()}
            if isinstance(tree, tuple):
                return tuple(to(v, d, double) for v in tree)
            if isinstance(tree, torch.Tensor):
                t = tree.to(d)
                return t.double() if double and t.is_floating_point() else t
            return tree

        def run(params, d, double=False):
            """(records, layer-0 output, attn_block_apply's output)."""
            recs: list = []

            def op(name, fn, *args):
                out = fn(*args)
                recs.append((name, fn, args, out))
                return out

            lp = to(T.layer_params(params["decoder"]["layers"], 0), d, double)
            x = L.embed(params["embedding"], torch.from_numpy(toks).to(d), c,
                        T._dtype(c)).to(d)
            pool = T.init_paged_pool(c, 1 + Bp * mpp, 16, device=d)
            ins = (torch.zeros(Bp, dtype=torch.int32, device=d),
                   torch.from_numpy(spans_np).to(d),
                   torch.from_numpy(table).to(d))
            if double:
                x, pool = x.double(), tree_map(lambda t: t.double(), pool)
            pages = T.layer_params(pool["layers"], 0)["attn"]
            y = _layer0_ops(lp, x, pages, *ins, c, win, op)
            y_block = T.attn_block_apply(
                lp, x, c, window=win, cache=T.layer_params(pool["layers"], 0),
                pos=ins[0], page_table=ins[2], span_len=ins[1])
            return recs, y, y_block

        card, y_card, yb_card = run(pg_, dev)
        cpu, y_cpu, yb_cpu = run(pc_, torch.device("cpu"))
        with Float64():
            fp64, y64, _ = run(pc_, torch.device("cpu"), double=True)
        require(torch.equal(y_card, yb_card) and torch.equal(y_cpu, yb_cpu),
                f"{c.name}: the op-by-op layer 0 is not attn_block_apply's")
        ops_ = []
        for (name, fn, args, out), (_, _, _, o_cpu), (_, _, _, o64) in zip(
                card, cpu, fp64):
            a32 = to(args, torch.device("cpu"))
            alone32 = fn(*a32)
            with Float64():
                alone64 = fn(*to(args, torch.device("cpu"), double=True))
            oc = rows(out)
            ops_.append({
                "op": name, "card_vs_cpu": _rel(oc, rows(o_cpu)),
                "card_vs_fp64": _rel(oc, rows(o64)),
                "cpu_vs_fp64": _rel(rows(o_cpu), rows(o64)),
                "alone": {"cpu_fp32_vs_card": _rel(oc, rows(alone32)),
                          "card_vs_fp64": _rel(oc, rows(alone64)),
                          "cpu_fp32_vs_fp64": _rel(rows(alone32),
                                                   rows(alone64))}})

        def first(get) -> Optional[str]:
            return next((o["op"] for o in ops_
                         if get(o)[0] > 2 * get(o)[1]), None)

        line = {"phase": "parity_ops", "model": c.name, "layer": 0,
                "T": Bp * Sp, "real_rows": int(real.sum()),
                "attention": "B3 (paged_attention_span)", "ops": ops_,
                "first_card_2x_farther_from_fp64": first(
                    lambda o: (o["card_vs_fp64"], o["cpu_vs_fp64"])),
                "first_card_2x_farther_alone": first(
                    lambda o: (o["alone"]["card_vs_fp64"],
                               o["alone"]["cpu_fp32_vs_fp64"]))}
        emit(line)
        return line

    parity_step(cfg32, p_gpu, p_cpu, rel, abs_err, lg_cpu,
                max_rel_err_graph_replays=graphed)
    require(max(graphed) <= PARITY_REL_TOL,
            f"card vs CPU logits differ under graph replay: rel {graphed}")
    phase_done("4 parity step")

    # random weights often decode one token over and over, so beyond token
    # identity every step's logits (rows with a span) are held to the
    # same limit as the single step above
    step_logits: list = []

    # the traces: _parity_draws's, drawn in phase 3
    stat_keys = ("mixed_steps", "preemptions", "prefix_hit_tokens",
                 "cow_forks", "kernel_dispatches", "dense_fallbacks")
    card_runs: dict = {}   # (phase, trace) -> the card's run, for phase 5

    def run_traces(phase: str, engine_kw: dict, exact: bool,
                   kernels: tuple[str, str], model=None, names=None,
                   sampled: bool = False) -> None:
        """The traces (``names``, default all three) on the card and on the
        CPU, of ``model`` (cfg, card params, CPU params; default phase
        4's).  ``exact``: tokens, counters and every step's logits held to
        the fp32 limits; else greedy tokens at least
        INT8_KV_TOKEN_AGREEMENT identical.  ``sampled``: every request
        samples at SAMPLE_TEMPERATURE from its own seed, the steps run
        drawing graphs, and a token may differ from the CPU's only at a
        near tie (:func:`_sampled_flips`), after which the two runs part."""
        c, pg_, pc_ = model or (cfg32, p_gpu, p_cpu)
        sampling = (SAMPLE_TEMPERATURE, 1000) if sampled else None
        for tname in names or traces:
            kw, prompts, stagger = traces[tname]
            outs, stats, seen, drawn = {}, {}, {}, {}
            for d in ("cuda", "cpu"):
                step_logits.clear()
                drawn[d] = {}
                eng = ContinuousBatchingEngine(
                    c, pg_ if d == "cuda" else pc_, page_size=16,
                    use_paged_kernel=True, device=d, **kw, **engine_kw)
                reset_launches()
                reqs = _drive(eng, prompts, stagger, 8,
                              f"trace {tname} on {d}", step_logits,
                              sampling, drawn[d] if sampled else None)
                eng.pool_host.check_invariants()
                outs[d] = [list(r.output_tokens) for r in reqs]
                stats[d] = {k: eng.stats[k] for k in stat_keys}
                seen[d] = list(step_logits)
                if d == "cuda":
                    counts = launches()
                    g = _graphs(eng)
                    replays = {"captures": g.captures, "replays": g.replays,
                               "buckets": g.buckets}
                    if not sampled and model is None:
                        card_runs[(phase, tname)] = {
                            "tokens": outs[d], "logits": seen[d],
                            "stats": stats[d]}
            flips = (_sampled_flips(outs["cuda"], outs["cpu"], drawn["cuda"],
                                    drawn["cpu"], *sampling)
                     if sampled else [])
            same_steps = len(seen["cuda"]) == len(seen["cpu"]) and all(
                a.shape == b.shape
                for a, b in zip(seen["cuda"], seen["cpu"]))
            step_rel = max(float((a - b).abs().max() / b.abs().max())
                           for a, b in zip(seen["cuda"], seen["cpu"]))
            flat = [(a, b) for oa, ob in zip(outs["cuda"], outs["cpu"])
                    for a, b in zip(oa, ob)]
            agree = sum(a == b for a, b in flat) / max(len(flat), 1)
            emit({"phase": phase, "model": c.name, "layers": c.n_layers,
                  "trace": tname, "cuda": outs["cuda"],
                  "cpu": outs["cpu"],
                  "identical": outs["cuda"] == outs["cpu"],
                  **({"temperature": sampling[0], "flips": flips,
                      "near_tie_flips": sum(f["near_tie"] for f in flips)}
                     if sampled else {}),
                  "token_agreement": agree,
                  "steps_compared": len(seen["cuda"]),
                  "max_step_rel_err": step_rel,
                  "rel_tol": PARITY_REL_TOL if exact else None,
                  "stats": stats["cuda"], "launches": counts,
                  "graphs": replays})
            require(all(len(o) == 8 for o in outs["cuda"]),
                    f"{phase} {tname}: a request returned too few tokens")
            require(counts[kernels[0]] > 0 and counts[kernels[1]] > 0
                    and stats["cuda"]["dense_fallbacks"] == 0,
                    f"{phase} {tname}: the card did not run {kernels}")
            require(replays["replays"] > 0 and replays["captures"]
                    + replays["replays"] == stats["cuda"]["mixed_steps"],
                    f"{phase} {tname}: every step after a bucket's first "
                    f"must replay its graph: {replays}")
            if sampled:
                require(any(draw for _, draw in replays["buckets"]),
                        f"{phase} {tname}: no step replayed a drawing "
                        f"graph: {replays}")
                require(all(f["near_tie"] for f in flips),
                        f"{phase} {tname}: a sampled token differs card vs "
                        f"CPU beyond a near tie: {flips}")
            if exact and not flips:
                require(same_steps, f"{phase} {tname}: card and CPU ran "
                        "other steps")
                require(outs["cuda"] == outs["cpu"],
                        f"{phase} {tname}: card and CPU tokens differ")
                require(stats["cuda"] == stats["cpu"],
                        f"{phase} {tname}: card and CPU stats differ")
                require(step_rel <= PARITY_REL_TOL,
                        f"{phase} {tname}: step logits differ: "
                        f"{step_rel}")
            elif not exact:
                require(agree >= INT8_KV_TOKEN_AGREEMENT,
                        f"{phase} {tname}: token agreement {agree}")
            if tname == "preemption":
                require(stats["cuda"]["preemptions"] > 0,
                        "the preemption trace preempted nothing")
            if tname == "prefix_cow":
                require(stats["cuda"]["prefix_hit_tokens"] > 0
                        and stats["cuda"]["cow_forks"] > 0,
                        "the prefix trace forked no page")

    run_traces("parity_tokens", {}, True,
               ("monarch_fused", "paged_attention_span"))
    phase_done("4 greedy traces")
    # the same traces with every request sampled at a temperature > 0
    run_traces("parity_tokens_sampled", {}, True,
               ("monarch_fused", "sample_tokens"), sampled=True)
    phase_done("4 sampled traces")

    # the fp32 weights' snapshot after 3 steps of the plain trace, taken
    # on the card and restored on the CPU, and the reverse: the continued
    # tokens are the uninterrupted card run's
    plain_kw, plain_prompts, _ = traces["plain"]
    snap_want = card_runs[("parity_tokens", "plain")]["tokens"]
    snap_params = {"cuda": p_gpu, "cpu": p_cpu}
    for src, dst in (("cuda", "cpu"), ("cpu", "cuda")):
        eng = ContinuousBatchingEngine(cfg32, snap_params[src], page_size=16,
                                       use_paged_kernel=True, device=src,
                                       **plain_kw)
        snap_done: dict = {}
        snap_reqs = _ft_serve(
            eng, snap_done, f"the serve to its snapshot on {src}",
            trace=[(p, SamplingParams(max_new_tokens=8))
                   for p in plain_prompts], steps=3)
        back = ContinuousBatchingEngine.restore(
            eng.snapshot(), cfg32, snap_params[dst], use_paged_kernel=True,
            device=dst)
        _ft_serve(back, snap_done, f"the snapshot restored on {dst}")
        snap_toks = [snap_done[r.req_id][0] for r in snap_reqs]
        emit({"phase": "parity_snapshot", "taken_on": src,
              "restored_on": dst, "tokens": snap_toks,
              "identical_to_card_run": snap_toks == snap_want})
        require(snap_toks == snap_want,
                f"a snapshot taken on {src} and restored on {dst} continued "
                f"with other tokens: {snap_toks} vs {snap_want}")
        del eng, back
    del snap_params
    phase_done("4 snapshot card <-> CPU")

    # the fp32 ServeEngine (the ring cache) on the card and on the CPU:
    # one prefill's and one decode step's logits within PARITY_REL_TOL,
    # then identical greedy tokens; and each prompt of the plain trace
    # alone through the card's ServeEngine, against the tokens the
    # continuous-batching engine gave it in that trace
    from repro_torch.serving import GenerationConfig, ServeEngine

    ring_engines = {"cuda": ServeEngine(cfg32, p_gpu, max_len=128),
                    "cpu": ServeEngine(cfg32, p_cpu, max_len=128,
                                       device="cpu")}
    rp = torch.from_numpy(np.random.default_rng(21).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32))
    ring_lg: dict = {}
    for d, se in ring_engines.items():
        cache = se._ring(4)
        lp, _ = se._prefill(se.params, rp.to(d), cache)
        ring_lg[d] = [lp[:, :cfg.vocab].float().cpu()]
    tok = torch.argmax(ring_lg["cpu"][0], -1).to(torch.int32)
    for d, se in ring_engines.items():
        ld, _ = T.decode_step(se.params, tok.to(d), se._rings[4], cfg32)
        ring_lg[d].append(ld[:, :cfg.vocab].float().cpu())
    ring_toks = {d: se.generate(rp, GenerationConfig(max_new_tokens=8))
                 for d, se in ring_engines.items()}
    ring_rel = [logit_err(a, b)[0]
                for a, b in zip(ring_lg["cuda"], ring_lg["cpu"])]
    cb_plain = card_runs[("parity_tokens", "plain")]["tokens"]
    alone = [ring_engines["cuda"].generate(
        np.asarray(p)[None], GenerationConfig(max_new_tokens=8))[0].tolist()
        for p in plain_prompts]
    emit({"phase": "parity_ring", "prefill_rel_err": ring_rel[0],
          "decode_rel_err": ring_rel[1], "rel_tol": PARITY_REL_TOL,
          "tokens_identical": torch.equal(ring_toks["cuda"],
                                          ring_toks["cpu"]),
          "tokens": ring_toks["cuda"].tolist(),
          "vs_continuous_batching": {"ring": alone, "paged": cb_plain,
                                     "identical": alone == cb_plain}})
    require(max(ring_rel) <= PARITY_REL_TOL,
            f"the fp32 ServeEngine: card vs CPU logits differ: {ring_rel}")
    require(torch.equal(ring_toks["cuda"], ring_toks["cpu"]),
            "the fp32 ServeEngine: card and CPU tokens differ")
    require(alone == cb_plain, f"the fp32 ServeEngine's tokens differ from "
            f"the continuous-batching engine's: {alone} vs {cb_plain}")
    del ring_engines, ring_lg
    phase_done("4 ring cache card <-> CPU")

    # -- 4b. int8 factors (fused QKV), fp32 KV: as exact as fp32 -------------
    q_gpu = prepare_decode_params(p_gpu, cfg32, fuse=True, bits=8)
    q_cpu = prepare_decode_params(p_cpu, cfg32, fuse=True, bits=8)
    rel, abs_err, _, _ = mixed_step_both({"cuda": q_gpu, "cpu": q_cpu})
    emit({"phase": "parity_step_int8_factors", "max_abs_err": abs_err,
          "max_rel_err": rel, "rel_tol": PARITY_REL_TOL})
    require(rel <= PARITY_REL_TOL,
            f"int8 factors: card vs CPU logits differ: rel {rel}")
    run_traces("parity_tokens_int8_factors",
               dict(quantize="int8", fuse_projections=True), True,
               ("monarch_fused_q", "paged_attention_span"))

    # -- 4c. int8 factors and int8 KV pages ---------------------------------
    rel, abs_err, (pool_card, pool_cpu), lg_cpu = mixed_step_both(
        {"cuda": q_gpu, "cpu": q_cpu}, kv_dtype="int8")

    def int8_pool_diff(a, b) -> list[dict]:
        """Per layer: the largest int8 step between stored values, how
        many differ, and the largest relative scale difference (the sink,
        page 0, excluded)."""
        a, b = a["layers"]["attn"], b["layers"]["attn"]
        rows = []
        for li in range(cfg32.n_layers):
            row = {"max_steps": 0, "values_differing": 0, "scale_rel": 0.0}
            for name in ("k_pages", "v_pages"):
                d = (a[name][li, 1:].int() - b[name][li, 1:].int()).abs()
                row["max_steps"] = max(row["max_steps"], int(d.max()))
                row["values_differing"] += int((d > 0).sum())
            for name in ("k_scales", "v_scales"):
                d = (a[name][li, 1:] - b[name][li, 1:]).abs()
                row["scale_rel"] = max(row["scale_rel"], float(
                    (d / b[name][li, 1:].abs().clamp(min=1e-30)).max()))
            rows.append(row)
        return rows

    def worst(rows) -> dict:
        return {"max_steps": max(r["max_steps"] for r in rows),
                "values_differing": sum(r["values_differing"] for r in rows),
                "scale_rel": max(r["scale_rel"] for r in rows)}

    card = int8_pool_diff(pool_card, pool_cpu)
    # the model's own sensitivity: the CPU against itself with every
    # embedding weight moved one ulp
    inf = float("inf")
    nudged = dict(q_cpu, embedding=tree_map(
        lambda t: torch.nextafter(t, torch.full_like(t, inf)),
        q_cpu["embedding"]))
    lg_n, pool_n = mixed_step_on(nudged, torch.device("cpu"), "int8")
    ref = int8_pool_diff(pool_n, pool_cpu)
    emit({"phase": "parity_step_int8_kv", "max_abs_err": abs_err,
          "max_rel_err": rel, "rel_tol": INT8_KV_STEP_REL_TOL,
          "page_values_per_layer": pool_cpu["layers"]["attn"]["k_pages"][
              0, 1:].numel() * 2,
          "first_layer": card[0], "scale_rel_tol": INT8_KV_SCALE_REL_TOL,
          "all_layers": worst(card),
          "max_steps_per_layer": [r["max_steps"] for r in card],
          "cpu_one_ulp_embedding": {"max_rel_err": logit_err(lg_n, lg_cpu)[0],
                                    "first_layer": ref[0],
                                    "all_layers": worst(ref)}})
    require(card[0]["max_steps"] <= 1,
            f"int8 pages of the first layer differ by "
            f"{card[0]['max_steps']} steps")
    require(card[0]["scale_rel"] <= INT8_KV_SCALE_REL_TOL,
            f"int8 KV scales of the first layer differ: rel "
            f"{card[0]['scale_rel']}")
    require(rel <= INT8_KV_STEP_REL_TOL,
            f"int8 KV: card vs CPU logits differ: rel {rel}")
    del pool_card, pool_cpu, pool_n
    run_traces("parity_tokens_int8_kv", qopts, False,
               ("monarch_fused_q", "paged_attention_span_q"))
    phase_done("4b/4c int8 factors and KV")

    # -- 4d. nemotron-4-15b at full width with the depth cut to 2 layers,
    # fp32 (the CPU side would otherwise run a 32-layer 15B-wide step): one
    # mixed step with the per-layer breakdown, and the plain greedy trace,
    # card vs CPU under the same limits ------------------------------------
    cfg_n2 = dataclasses.replace(cfg_n, n_layers=2, dtype="float32")
    pn_gpu = T.init_params(cfg_n2, seed=3, device=dev)
    pn_cpu = tree_to(pn_gpu, "cpu")
    rel, abs_err, _, lg_cpu_n = mixed_step_both(
        {"cuda": pn_gpu, "cpu": pn_cpu}, c=cfg_n2)
    parity_step(cfg_n2, pn_gpu, pn_cpu, rel, abs_err, lg_cpu_n)
    parity_ops(dataclasses.replace(cfg_n2, paged_kernel=True), pn_gpu,
               pn_cpu)
    phase_done("4d nemotron parity step")
    run_traces("parity_tokens_nemotron", {}, True, ("monarch_fused", "bdmm"),
               model=(cfg_n2, pn_gpu, pn_cpu), names=("plain",))
    del pn_gpu, pn_cpu
    torch.cuda.empty_cache()
    phase_done("4d nemotron trace")

    # -- 5. tensor parallelism on the one card ------------------------------
    # 5a. B7: the span kernel per rank on its heads of the phase-2 pools;
    # the ranks' outputs concatenated are the kernel on the whole pool
    def head_slices(tp, r, q, kp, vp, sc):
        h = slice(r * H // tp, (r + 1) * H // tp)
        kh = slice(r * KV // tp, (r + 1) * KV // tp)
        return (q[:, :, h].contiguous(), kp[:, :, kh].contiguous(),
                vp[:, :, kh].contiguous(),
                {k: v[:, kh].contiguous() for k, v in sc.items()})

    for tp in (2, 4):
        for cname, (S, starts, spans) in cases.items():
            st = torch.tensor(starts, dtype=torch.int32, device=dev)
            sl = torch.tensor(spans, dtype=torch.int32, device=dev)
            for win in (GLOBAL_WINDOW, 48):
                for dt in (f32, bf16):
                    for quant in (False, True):
                        dn = dn_of(dt)
                        name = "paged_attention_span_sharded" + (
                            "_q" if quant else "")
                        q = randn(B, S, H, hd, dtype=dt)
                        kp, vp, sc = ((kq, vq, dict(k_scales=ks, v_scales=vs))
                                      if quant else (k32.to(dt), v32.to(dt),
                                                     {}))
                        whole = paged_attention_span(q, kp, vp, pt, st, sl,
                                                     win, **sc)
                        outs, err, ok, again = [], 0.0, True, True
                        for r in range(tp):
                            ql, kl, vl, scl = head_slices(tp, r, q, kp, vp,
                                                          sc)
                            mesh_r = Mesh(model=tp, rank=r, device=dev)
                            o = paged_attention_span_sharded(
                                ql, kl, vl, pt, st, sl, win, mesh_r,
                                n_heads=H, n_kv_heads=KV, **scl)
                            e, okr = close(o, paged_attention_span_plain(
                                ql, kl, vl, pt, st, sl, win,
                                scl.get("k_scales"), scl.get("v_scales")),
                                dn)
                            again = again and torch.equal(
                                o, paged_attention_span_sharded(
                                    ql, kl, vl, pt, st, sl, win, mesh_r,
                                    n_heads=H, n_kv_heads=KV, **scl))
                            outs.append(o)
                            err, ok = max(err, e), ok and okr
                        same = torch.equal(torch.cat(outs, dim=2), whole)
                        errs[name] = max(errs[name], err)
                        line = {"phase": "kernel", "kernel": name, "tp": tp,
                                "case": cname, "S": S, "window": win,
                                "q_dtype": dn,
                                "page_dtype": "int8" if quant else dn,
                                "local_heads": H // tp,
                                "local_kv_heads": KV // tp,
                                "max_abs_err": err, "tol": TOL[dn],
                                "bitwise_concat_vs_unsharded": same,
                                "launch": span_launch(S, H // tp),
                                "deterministic": again}
                        if win == GLOBAL_WINDOW and cname != "prefill512":
                            # rank 0's launch, at its local shapes
                            ql, kl, vl, scl = head_slices(tp, 0, q, kp, vp,
                                                          sc)
                            mesh0 = Mesh(model=tp, rank=0, device=dev)
                            n_pages, n_pairs = span_work(starts, spans, win)
                            eb, pb = q.element_size(), kl.element_size()
                            bms, by = bound_ms(
                                2 * B * S * (H // tp) * hd * eb
                                + 2 * n_pages * pg * (KV // tp) * hd * pb
                                + (2 * n_pages * (KV // tp) * 4 if quant
                                   else 0),
                                4 * hd * (H // tp) * n_pairs,
                                all_bf16=dt == bf16 and not quant)
                            if quant:
                                kd_l = dequantize_kv_pages(
                                    kl, scl["k_scales"]).to(dt)
                                vd_l = dequantize_kv_pages(
                                    vl, scl["v_scales"]).to(dt)
                            else:
                                kd_l, vd_l = kl, vl
                            qq, kk, vv, mask = sdpa_args(ql, kd_l, vd_l, st,
                                                         S, win)
                            args = (ql, kl, vl, pt, st, sl, win)
                            line.update(timings(
                                kernel=lambda: paged_attention_span_sharded(
                                    *args, mesh0, n_heads=H, n_kv_heads=KV,
                                    **scl),
                                plain=lambda: paged_attention_span_plain(
                                    *args, scl.get("k_scales"),
                                    scl.get("v_scales")),
                                library=lambda: F.scaled_dot_product_attention(
                                    qq, kk, vv, attn_mask=mask)))
                            line.update(bound_ms=bms, bound_by=by,
                                        pages_read=n_pages)
                            if (tp == TP and cname == "decode"
                                    and dt == bf16):
                                summary[name] = summary_entry(line, bms, by)
                        emit(line)
                        require(ok and same and again,
                                f"{name} tp={tp} {cname} window={win} {dn}: "
                                f"err {err}, concat bitwise {same}, "
                                f"deterministic {again}")

    phase_done("5a B7")

    # 5b. the tp = 1 runs on the card the ranks are held to: phase 4's fp32
    # traces and phase 3's bf16 serve, the traces again with fp32 factors
    # over int8 KV pages, and with int4 factors (phase 4b's and 4c's int8
    # runs serve as theirs; the jobs and the tp = 1 snapshot: phase 3's)
    del q_gpu, q_cpu
    int8_base = _tp_rank(None, {"int8_kv": {"cfg": cfg32, "seed": 3,
                                            "traces": int8_traces}})
    int8_base = int8_base["int8_kv"]["traces"]
    int4_base = _tp_rank(None, {"int4_fused": {
        "cfg": cfg32, "seed": 3, "traces": qtp_traces["int4_fused"],
        "record": True}})["int4_fused"]["traces"]
    p32_sum = _checksum(p_gpu)
    del p_gpu, p_cpu
    torch.cuda.empty_cache()

    phase_done("5b tp=1 baselines")

    # 5c. TP ranks, one process each, sharing the card over gloo (started
    # in phase 3)
    jobs = tp_jobs
    ranks, tp_world_s = tp_world.result()
    emit({"phase": "tp_world", "ranks": TP, "backend": "gloo",
          "device": "cuda:0 (shared)", "seconds": tp_world_s,
          "world_beside": "phases 3-3d",
          "max_memory_allocated": [r["max_memory_allocated"]
                                   for r in ranks]})
    bases = {"fp32": {t: card_runs[("parity_tokens", t)] for t in traces},
             "int8_kv": int8_base, "bf16": {"serve": bf16_serve},
             "int8_fused": {t: card_runs[("parity_tokens_int8_factors", t)]
                            for t in traces},
             "int4_fused": int4_base,
             "int8_fused_int8_kv": {
                 t: card_runs[("parity_tokens_int8_kv", t)] for t in traces}}
    checksums = {job: p32_sum for job in jobs}
    checksums["bf16"] = bf16_serve["checksum"]
    # jobs held exactly to tp = 1 (fp32 pages); the others over int8 pages
    exact_jobs = ("fp32", "int8_fused", "int4_fused")
    for job, spec in jobs.items():
        require(all(r[job]["checksum"] == checksums[job] for r in ranks),
                 f"tp {job}: the ranks initialized other weights")
        for tname in spec["traces"]:
            rs = [r[job]["traces"][tname] for r in ranks]
            base = bases[job][tname]
            toks = rs[0]["tokens"]
            flat = [(a, b) for oa, ob in zip(toks, base["tokens"])
                    for a, b in zip(oa, ob)]
            agree = sum(a == b for a, b in flat) / max(len(flat), 1)
            line = {"phase": "tp_serve", "job": job, "trace": tname,
                    "tp": TP, "tokens": toks, "tp1_tokens": base["tokens"],
                    "identical_to_tp1": toks == base["tokens"],
                    "token_agreement": agree,
                    "ranks_identical": all(r["tokens"] == toks for r in rs),
                    "stats": rs[0]["stats"],
                    "per_rank": [{k: r[k] for k in (
                        "launches", "seconds", "tokens_per_s",
                        "pages_per_shard", "local_page_shape")}
                        for r in rs]}
            steps = rs[0]["stats"]["mixed_steps"]
            line["launches_per_step"] = [
                {k: v / steps for k, v in r["launches"].items() if v}
                for r in rs]
            if job in exact_jobs:
                a, b = rs[0]["logits"], base["logits"]
                same_steps = len(a) == len(b) and all(
                    x.shape == y.shape for x, y in zip(a, b))
                require(same_steps, f"tp {tname}: other steps than tp=1")
                line["max_step_rel_err"] = max(
                    float((x - y).abs().max() / y.abs().max())
                    for x, y in zip(a, b))
                line["rel_tol"] = PARITY_REL_TOL
            emit(line)
            require(line["ranks_identical"],
                    f"tp {job} {tname}: the ranks' tokens differ")
            span_k = ("paged_attention_span_sharded_q" if "int8_kv" in job
                      else "paged_attention_span_sharded")
            # B4 on fused QKV, wo, w1, w2; B1 on the six projections
            mon_k, per_layer = (("monarch_fused_q", 4) if job in qtp_opts
                                else ("monarch_fused", 6))
            for r in rs:
                c = r["launches"]
                require(r["stats"] == rs[0]["stats"],
                        f"tp {job} {tname}: the ranks' counters differ")
                require(c[span_k] == cfg.n_layers * steps
                        and c[mon_k] == per_layer * cfg.n_layers * steps
                        and sum(c[k] for k in ("monarch_fused",
                                               "monarch_fused_q"))
                        == c[mon_k]
                        and c["paged_attention_span"] == 0
                        and c["paged_attention_span_q"] == 0
                        and c["bdmm"] == 0 and c["bdmm_q"] == 0
                        and r["stats"]["dense_fallbacks"] == 0,
                        f"tp {job} {tname}: launches {c} over {steps} steps")
            if job in exact_jobs:
                require(toks == base["tokens"],
                        f"tp {job} {tname}: tokens differ from tp=1")
                require(line["max_step_rel_err"] <= PARITY_REL_TOL,
                        f"tp {job} {tname}: step logits differ: "
                        f"{line['max_step_rel_err']}")
                require(rs[0]["stats"] == base["stats"],
                        f"tp {job} {tname}: counters differ from tp=1")
            elif "int8_kv" in job:
                require(agree >= INT8_KV_TOKEN_AGREEMENT,
                        f"tp int8 KV {tname}: token agreement {agree}")
        if spec.get("profile"):
            emit({"phase": "tp_profile", "job": job,
                  "note": "two ranks time-slice one card without MPS, "
                          "beside phases 3-3d",
                  "per_rank": [r[job]["profile"] for r in ranks]})
    # the main path's launches: the bf16 serve's (B7), the int8-KV traces'
    # (B7 over int8 pages); counts of rank 0
    serve_counts["paged_attention_span_sharded"] = \
        ranks[0]["bf16"]["traces"]["serve"]["launches"][
            "paged_attention_span_sharded"]
    serve_counts["paged_attention_span_sharded_q"] = sum(
        ranks[0]["int8_kv"]["traces"][t]["launches"][
            "paged_attention_span_sharded_q"] for t in int8_traces)

    phase_done("5c tp ranks")

    # 5d. the snapshots across meshes: the tp = 1 snapshot continued at
    # tp = 2 (every rank, in 5c), and the ranks' tp = 2 snapshot continued
    # at tp = 1 on the card; both to the uninterrupted tp = 1 run's tokens
    snap_want = card_runs[("parity_tokens", "plain")]["tokens"]
    for rank, r in enumerate(ranks):
        res = r["snapshot"]["snapshot"]
        snap_done = {**tp1_done, **res["restored"]}
        snap_toks = [snap_done[q.req_id][0] for q in tp1_reqs]
        snap_c = res["launches"]
        emit({"phase": "tp_snapshot", "direction": f"tp=1 -> tp={TP}",
              "rank": rank, "tokens": snap_toks,
              "identical_to_tp1": snap_toks == snap_want,
              "launches": snap_c})
        require(snap_toks == snap_want, f"the tp=1 snapshot continued at "
                f"tp={TP} with other tokens on rank {rank}")
        require(snap_c["paged_attention_span_sharded"] > 0
                and snap_c["paged_attention_span"] == 0,
                f"the restored tp={TP} engine did not run B7: {snap_c}")
    p_gpu = T.init_params(cfg32, seed=3, device=dev)
    snap_ranks = ranks[0]["snapshot"]["snapshot"]
    back = ContinuousBatchingEngine.restore_latest(
        tp_dirs[TP], cfg32, p_gpu, use_paged_kernel=True)
    reset_launches()
    snap_done = dict(snap_ranks["before"])
    _ft_serve(back, snap_done, f"the tp={TP} snapshot restored at tp=1")
    snap_toks = [snap_done[i][0] for i in snap_ranks["req_ids"]]
    snap_c = launches()
    emit({"phase": "tp_snapshot", "direction": f"tp={TP} -> tp=1",
          "tokens": snap_toks, "identical_to_tp1": snap_toks == snap_want,
          "kv_shard": back.kv.kv_shard, "launches": snap_c,
          "graphs": _graph_stats(back)})
    require(snap_toks == snap_want, f"the tp={TP} snapshot continued at tp=1 "
            f"with other tokens: {snap_toks} vs {snap_want}")
    require(snap_c["paged_attention_span"] > 0
            and snap_c["paged_attention_span_sharded"] == 0,
            f"the restored tp=1 engine did not run B3: {snap_c}")
    del back, p_gpu
    shutil.rmtree(FT_DIR, ignore_errors=True)
    phase_done("5d tp snapshots")

    # -- 5e. every family at tp = 2 on the card: granite-moe-1b-a400m (bf16,
    # fp32) and qwen2-moe-a2.7b (fp32, int8 fused) through the engine with
    # expert parallelism, mamba2-2.7b, zamba2-7b and seamless-m4t-large-v2
    # through the serving steps, each held to its tp = 1 run on the card
    _phase_tp_families(dev, tpf_world)
    worlds.shutdown()
    tp_pool.shutdown()
    phase_done("5e tp families")

    # -- 6. the dry run held to 3i's and 3j's steps: 3j's collectives
    # exactly, 3i's peaks within DRYRUN_PEAK_TOL, its FLOPs card == meta --
    torch.cuda.empty_cache()
    _phase_dryrun(dev, train_run, mesh_run)
    phase_done("6 dry run")

    # -- summary --------------------------------------------------------------
    kernels = []
    for name in KERNELS:
        s = summary[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": serve_counts[name],
            "max_abs_err": errs[name], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "card_ms": s["card_ms"],
            "library_card_ms": s["library_card_ms"],
            **({"replaces_kind": "jnp compiled by XLA in the jitted step, "
                                 "not Pallas"}
               if name in JNP_KERNELS else {}),
            **({"replaces_kind": "the Pallas kernel under jax.vmap over "
                                 f"the experts ({VMAPPED[name]})"}
               if name in VMAPPED else {})})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(_card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        WORLD_STOP.set()
    sys.exit(code)
