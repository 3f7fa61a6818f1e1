#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    PYTHONPATH=src python3 chip_smoke.py

    PYTHONPATH=src python3 chip_smoke.py --calls   # B2/B5 alone (below)

    PYTHONPATH=src python3 chip_smoke.py --serves  # profiled serves alone

Phases, each printed as one JSON object per line:

  1. build    compile every CUDA kernel from ``src/repro_torch/kernels/csrc``,
              with each kernel's registers and spills from ptxas
  2. kernels  B2/B5 (bdmm, bdmm_q) at their call sets first: both stages
              of a 128-block decode layer, of the 4096 x 4096 128-block
              pair and of nemotron-4-15b's and codeqwen1.5-7b's staged
              feed-forward pairs, bf16 x, fp32 / int8 / int4 weights, T = 8
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
              gpt2-medium's and nemotron-4-15b's vocabularies
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
              replays torch.equal to eager steps and a profiled window
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
              its per-layer breakdown) and a greedy trace
  5. tp       tensor parallelism on the one card: B7, the span kernel per
              rank on its heads of the phase-2 pools (tp 2 and 4, float and
              int8 pages), against its plain version and, concatenated,
              ``torch.equal`` to B3/B6 on the whole pool; then TP = 2 ranks,
              one spawned process each, sharing ``cuda:0`` over gloo (NCCL
              refuses two ranks on one device): phase 4's fp32 traces
              (tokens equal to the card's tp = 1, every step's logits within
              PARITY_REL_TOL), the same traces over int8 KV pages (tokens
              >= INT8_KV_TOKEN_AGREEMENT of tp = 1's) and phase 3's bf16
              serve (a reading) with a profiled window; every rank runs 24
              B7 launches and 144 local Monarch launches a step, no
              float-page span launch and no dense fallback

It exits non-zero on the first failed check, and when a rank fails.  Each
phase ends with its seconds (``phase_seconds``).  The
last lines are the per-kernel summary, the card's name and power limit
from ``nvidia-smi``, and ``{"ok": true, "device": {...}}``.  It needs one
CUDA device and never imports JAX or the reference package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 without tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
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

KERNELS = ("monarch_fused", "bdmm", "paged_attention_span",
           "monarch_fused_q", "bdmm_q", "paged_attention_span_q",
           "paged_attention_span_sharded", "paged_attention_span_sharded_q",
           "quantize_kv_write", "sample_tokens")
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
}
# the profiler's kernel names (substrings) and the launch counters that
# count them: each counted launch of quantize_kv_write is one
# kv_store_kernel (with a memset and two more kernels before it), each of
# sample_tokens one sample_partial_kernel (and one merge after it)
PROFILED = {"monarch_fused_kernel": ("monarch_fused", "monarch_fused_q"),
            "bdmm_": ("bdmm", "bdmm_q"),
            "paged_span_kernel": ("paged_attention_span",
                                  "paged_attention_span_q",
                                  "paged_attention_span_sharded",
                                  "paged_attention_span_sharded_q"),
            "kv_store_kernel": ("quantize_kv_write",),
            "sample_partial_kernel": ("sample_tokens",)}
# the least share of a window's counted launches the profiler must show
PROFILED_SHARE = 0.9
# ranks of the tensor-parallel phase: processes that share the one card
TP = 2
# B2/B5's call sets: the projections (din, dout) whose factors take the
# staged branch, and their blocks (None: make_dims' paper policy)
BDMM_CALL_SETS = {
    # (a) one gpt2-medium decode layer at 128 blocks (B5: QKV fused)
    "a_gpt2_layer_nb128": ([(1024, 1024)] * 4 + [(1024, 4096),
                                                 (4096, 1024)], 128),
    # (b) the 4096 x 4096 pair at 128 blocks
    "b_4096x4096_nb128": ([(4096, 4096)], 128),
    # (c), (d) nemotron-4-15b's FFN (d_model 6144, d_ff 24576)
    "c_nemotron_w1": ([(6144, 24576)], None),
    "d_nemotron_w2": ([(24576, 6144)], None),
    # (e) codeqwen1.5-7b's FFN down projection (d_ff 13440, d_model 4096)
    "e_codeqwen_w2": ([(13440, 4096)], None),
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    # one profile a step: a window of 8 steps' launches in one profile can
    # overflow the tracer's buffers and drop kernel records
    counted0 = launches()
    by_key: dict = {}
    for _ in range(n_steps):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.step()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue  # host ops also carry their kernels' device time
            dt = getattr(e, "self_device_time_total", None)
            if dt is None:
                dt = e.self_cuda_time_total
            us, n = by_key.get(e.key, (0.0, 0))
            by_key[e.key] = (us + dt, n + e.count)
    counted = launches()
    rows = sorted(((us / 1e3 / n_steps, key, n)
                   for key, (us, n) in by_key.items()), reverse=True)
    device = sum(r[0] for r in rows)
    watched = {w: [sum(r[0] for r in rows if w in r[1]),
                   sum(r[2] for r in rows if w in r[1]) / n_steps]
               for w in watch}
    # launches a step: the counters (a graph's replay adds its capture's),
    # and the kernels the profiler saw by name, a reading: it can drop a
    # kernel record now and then, eager or replayed
    per_step = {c: (counted[c] - counted0.get(c, 0)) / n_steps
                for c in counted if counted[c] != counted0.get(c, 0)}
    profiled = {name: [sum(r[2] for r in rows if name in r[1]) / n_steps,
                       sum(per_step.get(c, 0) for c in ctrs)]
                for name, ctrs in PROFILED.items()}
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
    out = {"wall_ms_per_step": wall * 1e3,
           "device_ms_per_step": device,
           "device_busy_share": device / (wall * 1e3),
           "tokens_per_s": toks / (wall * n_steps),
           "host_ms_per_step": (host - replay - waited[0]) / n_steps * 1e3,
           "harvest_wait_ms_per_step": waited[0] / n_steps * 1e3,
           "host_syncs_per_step": syncs / n_steps,
           "launches_per_step": per_step,
           "launches_per_step_profiled_vs_counted": profiled,
           "watched_ms_launches_per_step": watched,
           "top_kernels_ms_per_step": [
               [name[:70], ms, n / n_steps] for ms, name, n in rows[:8]]}
    if g:
        out["graphs"] = {"captures": g.captures - graphs0[0],
                         "replays": g.replays - graphs0[1],
                         "replay_host_ms_per_step": replay / n_steps * 1e3,
                         "buckets": g.buckets}
    return out


def _profile_serve(cfg, params, watch: tuple = (), **engine_kw) -> dict:
    """A warmed engine (:func:`_warm`), then a fresh batch of 8 x 256-token
    prompts: one prefill step, then 8 decode steps once every request is
    decoding (``watch`` as in :func:`_window`).  Under graphs every
    window replays without a capture, its launches a step are those of
    an eager step of its bucket (:func:`_eager_launches`); eager or
    replayed, the profiler shows at least ``PROFILED_SHARE`` of each
    kernel family's counted launches."""
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
        # launches in every H100 run so far), never a family's launches
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
    tokens, the logits, the token and keys after the step and every page
    and scale ``torch.equal``.  A float pool's sink page (page 0) is left out: the
    padding rows' writes collide there, and an index_put on the card
    resolves duplicates in no fixed order (the int8 pool's kernel does,
    so its sink is compared too).  The engine's pool takes the replay's
    writes: it is not served after this."""
    import torch

    from repro_torch import tree_map

    g = _graphs(eng)
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
                    if a.dim() == 5 and a.dtype != torch.int8
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
        del params
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return out


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
    from repro_torch.launch.mesh import Mesh, run_ranks
    from repro_torch.models import transformer as T
    from repro_torch.models.decode_path import (decode_weight_bytes,
                                                prepare_decode_params)
    from repro_torch.models.fuse import fuse_linears
    from repro_torch.serving import ContinuousBatchingEngine

    # fp32 products in full precision everywhere (PyTorch's default for
    # matmul; stated so no environment can turn TF32 on under the check)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    t_phase = [t_start]

    def phase_done(name: str) -> None:
        """Print the seconds since the last phase ended."""
        now = time.perf_counter()
        emit({"phase": "phase_seconds", "name": name,
              "seconds": now - t_phase[0]})
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
        back on the card."""
        for _ in range(3):
            fn()
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
    # output through its transposed view), bf16 x, fp32 factors (B2) or
    # int8 / int4 (B5), at T = 8 and 512; each line with both stages'
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
            wt = wf.to(torch.bfloat16).transpose(1, 2)
            out.append({**call, "blocks": tuple(wf.shape),
                        "library": lambda x, wt=wt: torch.matmul(
                            x.transpose(0, 1), wt).transpose(0, 1)})
        return out

    def run_stages(calls: list, xs: list, which: str) -> list:
        """Every projection's stage 1 on its x, stage 2 on stage 1's
        output through the transposed view; the outputs."""
        outs = []
        for x, (s1, s2) in zip(xs, calls):
            u = s1[which](x.view(x.shape[0], s1["blocks"][0], -1))
            outs += [u, s2[which](u.transpose(1, 2))]
        return outs

    def stage_geometry(T_, blocks, bits, contiguous) -> dict:
        k, q, p = blocks
        g = geometry_of(T_, k, q, p, 2, bits, contiguous)
        return {"blocks": [k, q, p], **g._asdict()}

    def bdmm_call_set(name: str, T_: int, bits: int, fs: list) -> dict:
        """One kernel line: the call set's stages at T_ tokens, bf16 x;
        bits 32: B2 on fs, else B5 on fs quantized to ``bits``."""
        calls = [stage_calls(quantize_monarch(f, bits), bits) if bits < 32
                 else stage_calls(f) for f in fs]
        xs = [torch.randn(T_, f["L"].shape[0] * f["L"].shape[2],
                          generator=gb, device=dev).to(torch.bfloat16)
              for f in fs]
        err, ok, again, same = 0.0, True, True, True
        n_bytes = flops = 0
        geos = {}
        for x, (s1, s2) in zip(xs, calls):
            x3 = x.view(T_, s1["blocks"][0], -1)
            u = s1["kernel"](x3)
            ut = u.transpose(1, 2)
            y = s2["kernel"](ut)
            for s_, xin, out in ((s1, x3, u), (s2, ut, y)):
                e, o = close(out, s_["plain"](xin), "bfloat16")
                err, ok = max(err, e), ok and o
                again = again and torch.equal(out, s_["kernel"](xin))
                if "twin" in s_:
                    same = same and torch.equal(out, s_["twin"](xin))
                k, q, p = s_["blocks"]
                n_bytes += 2 * T_ * k * (p + q) + s_["w_bytes"]
                flops += 2 * T_ * k * q * p
                if geometry_of is not None:
                    geos.setdefault(f"{k}x{q}x{p}", stage_geometry(
                        T_, s_["blocks"], bits, xin.stride(2) == 1))
        # decode sums with fp32 FMA; prefill with TF32 tensor cores, two
        # products a multiply-add (bf16 x has no small half)
        tc = T_ > 16
        peak = TF32_FLOPS_PER_S / 2 if tc else FP32_FLOPS_PER_S
        bms, by = bound_ms(n_bytes, flops, False, peak)
        kind = "bdmm" if bits == 32 else "bdmm_q"
        line = {"phase": "kernel", "kernel": kind, "call_set": name,
                "T": T_, "x_dtype": "bfloat16",
                "weights": {32: "float32", 8: "int8", 4: "int4"}[bits],
                "launches": 2 * len(fs), "max_abs_err": err,
                "tol": TOL["bfloat16"], "deterministic": again,
                **({"bitwise_vs_bdmm": same} if bits < 32 else {}),
                "launch": geos or None,
                **timings(kernel=lambda: run_stages(calls, xs, "kernel"),
                          plain=lambda: run_stages(calls, xs, "plain"),
                          library=lambda: run_stages(calls, xs, "library")),
                "bound_ms": bms, "bound_by": by,
                "bound_rate": "tf32 tensor cores / 2 products" if tc else
                "fp32 fma"}
        emit(line)
        errs[kind] = max(errs[kind], err)
        require(ok and again and same,
                f"{kind} {name} T={T_} int{bits}: err {err}, deterministic "
                f"{again}, bitwise {same}")
        return line

    bdmm_lines: dict = {}
    bdmm_sets: dict = {}
    for name, (proj, nblocks) in BDMM_CALL_SETS.items():
        fs = [init_monarch(gb, make_dims(din, dout, policy="paper",
                                         nblocks=nblocks), device=dev)
              for din, dout in proj]
        require(not any(fused_fits(f["L"].shape, f["R"].shape) for f in fs),
                f"{name} must take the staged branch")
        # B5 on the quantized decode path's layer: QKV fused
        fq = [fuse_linears(fs[:3])] + fs[3:] if len(fs) == 6 else fs
        bdmm_sets[name] = (fs, fq)
        for T_ in (8, 512):
            for bits in (32, 8, 4):
                bdmm_lines[name, T_, bits] = bdmm_call_set(
                    name, T_, bits, fs if bits == 32 else fq)
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

    def device_ms(fn, n: int = 10) -> float:
        """Device kernel time of one ``fn()`` from torch.profiler: what the
        card spends, without the host's time to issue the launches."""
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
                        "device_ms": device_ms(kern), "T": T_,
                        "grid": [fused_geometry(f["L"].shape, f["R"].shape,
                                                T_, 2, 32).grid
                                 for f in fs]}

    # B2/B5: their call sets of phase 2b0, bf16 x; the decode layer (a)
    # at T = 8 (B5 int8, QKV fused) as before, at T = 512, and the FFN
    # call sets (c)-(e) at both
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
        for name in ("c_nemotron_w1", "d_nemotron_w2", "e_codeqwen_w2")
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
            "device_ms": device_ms(kern), "T": T_,
            "grid": [fused_geometry(f["L"].shape, f["R"].shape, T_, 2,
                                    8).grid for f in fs]}

    summary["paged_attention_span_q"] = summary_entry(
        paged_q_summary, paged_q_summary["bound_ms"],
        paged_q_summary["bound_by"])
    emit({"phase": "kernel_summary",
          "what": "one bf16 decode layer at T=8 (B1/B4: its projections, "
                  "B4 int8 with fused QKV; B2/B5: the same at 128 blocks; "
                  "B3/B6: one decode call); B1/B2/B4/B5 also one prefill "
                  "layer at T=512 (*_T512); bdmm_ffn: B2 at the FFN call "
                  "sets; device_ms: torch.profiler's kernel time, grid: "
                  "blocks per launch", "summary": summary})

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
                             "device_ms": device_ms(launch, 20),
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
    summary["sample_tokens"] = summary_entry(
        x3_summary, x3_summary["bound_ms"], x3_summary["bound_by"])
    phase_done("2 kernels")

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

    def graphs_replayed(eng, what: str, compare: bool = True) -> dict:
        """Every step of a tp = 1 serve on the card replays a captured
        graph but each bucket's first; with ``compare``, each bucket's
        replay is the eager step (:func:`_replay_vs_eager`)."""
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
          "graphs": graphs_replayed(eng, "serve")})
    require(counts["monarch_fused"] > 0, "serve launched no monarch_fused")
    require(counts["paged_attention_span"] > 0,
            "serve launched no paged_attention_span")
    require(st_["dense_fallbacks"] == 0, "serve fell back to dense attention")
    require(counts["sample_tokens"] > 0,
            "the serve drew no token through sample_tokens")
    serve_counts = dict(counts)
    del eng

    emit({"phase": "serve_profile", **_profile_serve(cfg, params)})
    emit({"phase": "serve_cow_window", **_cow_window(cfg, params)})

    # -- 3b. the compressed decode path: fused QKV, int8/int4 factors, int8
    # KV pages --------------------------------------------------------------
    qopts = dict(quantize="int8", fuse_projections=True, kv_dtype="int8")
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
          "graphs": graphs_replayed(eng, "quantized serve")})
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
          "graphs": graphs_replayed(eng, "int4 serve", compare=False)})
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
          "graphs": graphs_replayed(eng, "staged serve", compare=False)})
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
          "graphs": graphs_replayed(eng, "staged int8 serve",
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
          "graphs": graphs_replayed(eng, "nemotron serve")})
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
          "graphs": graphs_replayed(eng, "nemotron int8 serve")})
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
    del params
    torch.cuda.empty_cache()
    phase_done("3c nemotron serve")

    # -- 4. card vs CPU at full width, fp32 ---------------------------------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p_gpu = T.init_params(cfg32, seed=3, device=dev)
    p_cpu = tree_to(p_gpu, "cpu")
    Bp, Sp, mpp = 4, 64, 8
    prng = np.random.default_rng(3)
    toks = prng.integers(0, cfg.vocab, (Bp, Sp)).astype(np.int32)
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

    parity_step(cfg32, p_gpu, p_cpu, rel, abs_err, lg_cpu,
                max_rel_err_graph_replays=graphed)
    require(max(graphed) <= PARITY_REL_TOL,
            f"card vs CPU logits differ under graph replay: rel {graphed}")
    phase_done("4 parity step")

    # random weights often decode one token over and over, so beyond token
    # identity every step's logits (rows with a span) are held to the
    # same limit as the single step above
    step_logits: list = []

    prefix = list(prng.integers(0, cfg.vocab, 40))
    shared = [np.asarray(prefix + [(17 * i + j) % cfg.vocab
                                   for j in range(3 + i % 2)])
              for i in range(4)]
    traces = {
        # (engine options, prompts, add one request every n steps; 0: all
        # at once)
        "plain": (dict(max_slots=4, max_len=128, chunk_size=64),
                  [prng.integers(0, cfg.vocab, int(n))
                   for n in (16, 33, 48, 64)], 0),
        # 8 usable pages for 14 pages of demand: preemptions mid-flight
        "preemption": (dict(max_slots=4, max_len=128, chunk_size=16,
                            n_pages=9),
                       [prng.integers(0, cfg.vocab, int(n))
                        for n in (16, 33, 48, 64)], 0),
        # a shared 40-token prefix; the repeat of the second prompt and
        # the extension of the first match a committed partial page and
        # fork it copy-on-write
        "prefix_cow": (dict(max_slots=4, max_len=128, chunk_size=16),
                       shared + [shared[1],
                                 np.concatenate([shared[0], [5, 6]])], 3),
    }
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
    # traces and phase 3's bf16 serve, and the traces again with fp32
    # factors over int8 KV pages (phase 4c's had int8 factors, which
    # tensor parallelism does not take)
    del q_gpu, q_cpu
    fp32_traces = {t: (dict(page_size=16, use_paged_kernel=True, **kw),
                       [np.asarray(p) for p in prompts], stagger, 8)
                   for t, (kw, prompts, stagger) in traces.items()}
    int8_traces = {t: ({**kw, "kv_dtype": "int8"}, *rest)
                   for t, (kw, *rest) in fp32_traces.items()}
    int8_base = _tp_rank(None, {"int8_kv": {"cfg": cfg32, "seed": 3,
                                            "traces": int8_traces}})
    int8_base = int8_base["int8_kv"]["traces"]
    p32_sum = _checksum(p_gpu)
    del p_gpu, p_cpu
    torch.cuda.empty_cache()

    phase_done("5b tp=1 baselines")

    # 5c. TP ranks, one process each, sharing the card over gloo
    jobs = {
        "fp32": {"cfg": cfg32, "seed": 3, "traces": fp32_traces,
                 "record": True},
        "int8_kv": {"cfg": cfg32, "seed": 3, "traces": int8_traces},
        "bf16": {"cfg": cfg, "seed": 0, "profile": True, "traces": {
            "serve": ({**SERVE_KW, "pool_bytes": fp_serve["pool_bytes"]},
                      _serve_prompts(cfg.vocab, 8, 32, 256, 0), 0, 32)}},
    }
    t0 = time.perf_counter()
    ranks = run_ranks(_tp_rank, TP, backend="gloo", device="cuda:0",
                      args=(jobs,), timeout_s=900)
    emit({"phase": "tp_world", "ranks": TP, "backend": "gloo",
          "device": "cuda:0 (shared)", "seconds": time.perf_counter() - t0,
          "max_memory_allocated": [r["max_memory_allocated"]
                                   for r in ranks]})
    bases = {"fp32": {t: card_runs[("parity_tokens", t)] for t in traces},
             "int8_kv": int8_base, "bf16": {"serve": bf16_serve}}
    checksums = {"fp32": p32_sum, "int8_kv": p32_sum,
                 "bf16": bf16_serve["checksum"]}
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
            if job == "fp32":
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
            steps = rs[0]["stats"]["mixed_steps"]
            span_k = ("paged_attention_span_sharded_q" if job == "int8_kv"
                      else "paged_attention_span_sharded")
            for r in rs:
                c = r["launches"]
                require(r["stats"] == rs[0]["stats"],
                        f"tp {job} {tname}: the ranks' counters differ")
                require(c[span_k] == cfg.n_layers * steps
                        and c["monarch_fused"] == 6 * cfg.n_layers * steps
                        and c["paged_attention_span"] == 0
                        and c["paged_attention_span_q"] == 0
                        and c["bdmm"] == 0
                        and r["stats"]["dense_fallbacks"] == 0,
                        f"tp {job} {tname}: launches {c} over {steps} steps")
            if job == "fp32":
                require(toks == base["tokens"],
                        f"tp fp32 {tname}: tokens differ from tp=1")
                require(line["max_step_rel_err"] <= PARITY_REL_TOL,
                        f"tp fp32 {tname}: step logits differ: "
                        f"{line['max_step_rel_err']}")
                require(rs[0]["stats"] == base["stats"],
                        f"tp fp32 {tname}: counters differ from tp=1")
            elif job == "int8_kv":
                require(agree >= INT8_KV_TOKEN_AGREEMENT,
                        f"tp int8 KV {tname}: token agreement {agree}")
        if spec.get("profile"):
            emit({"phase": "tp_profile", "job": job,
                  "note": "two ranks time-slice one card without MPS",
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
               if name in JNP_KERNELS else {})})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
