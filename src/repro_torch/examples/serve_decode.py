"""Serving example (port of ``examples/serve_decode.py``): unified
chunked-prefill + decode over the paged KV cache, or the legacy
single-batch engine over the ring cache.

Submits a ragged burst of requests (mixed prompt lengths, per-request
sampling params), streams tokens as they are produced, and reports
scheduler/pool statistics, the kernels' launches, and the cost model's
simulated latency/energy (``--cost-model cim``, the default; ``hbm``
prices weight and KV traffic).  ``--chunk-size`` bounds the prompt tokens
one sequence prefills a step; ``--preempt`` shrinks the page pool so
sequences are evicted and resumed mid-flight; ``--system-prompt N``
prepends one synthetic N-token prompt to every request, whose pages later
arrivals share through the prefix trie (``--no-prefix-sharing`` turns it
off); ``--kv-dtype int8`` serves quantized KV pages; ``--quantize`` and
``--fuse`` prepare the decode fast path at load; ``--deadline-s`` bounds
every request's lifetime; ``--metrics`` prints the telemetry report and
``--trace-out PATH`` saves a Chrome trace of the engine's iterations.
``--engine legacy`` serves one batch through ``ServeEngine``, as every
Mamba or hybrid model (``--arch mamba2-2_7b``, ``zamba2-7b``) is served:
the continuous-batching engine needs an attention stack.

The model is the ``.reduced()`` config of ``--arch`` with seeded random
weights (``init_params``, seed 0), its Monarch projections through the
hand-written kernel (B1/B2, or B4/B5 on quantized factors; their plain
versions on the CPU); the prompts come from a seeded torch generator.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
          [--engine legacy] [--arch mamba2-2_7b] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.kernels import launches, reset_launches
from repro_torch.models import transformer as T
from repro_torch.serving import (CIMCostModel, ContinuousBatchingEngine,
                                 GenerationConfig, HBMCostModel,
                                 SamplingParams, SchedulerConfig, ServeEngine)


def _launched() -> dict:
    return {k: n for k, n in launches().items() if n}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="codeqwen1_5-7b")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--chunk-size", type=int, default=8,
                    help="max prompt tokens one sequence prefills per step")
    ap.add_argument("--preempt", action="store_true",
                    help="shrink the page pool so mid-flight preemption "
                         "(evict + recompute-on-resume) actually fires")
    ap.add_argument("--system-prompt", type=int, default=0, metavar="N",
                    help="shared synthetic N-token system prompt: requests "
                         "share its KV pages via the prefix trie")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable the refcounted prefix trie (baseline)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock deadline: the engine's "
                         "deadline sweep drives expired requests to "
                         "FINISHED/TIMEOUT with pages freed")
    ap.add_argument("--cost-model", choices=["none", "hbm", "cim"],
                    default="cim")
    ap.add_argument("--paged-kernel", action="store_true",
                    help="attention through the paged span kernel (B3)")
    ap.add_argument("--engine", choices=["continuous", "legacy"],
                    default="continuous")
    ap.add_argument("--quantize", choices=["int8", "int4"], default=None,
                    help="per-block quantized Monarch factors at load")
    ap.add_argument("--fuse", action="store_true",
                    help="fuse QKV / gate-up projections at load")
    ap.add_argument("--kv-dtype", choices=["fp32", "bf16", "int8"],
                    default=None,
                    help="stored KV page width (int8: quantized pages with "
                         "per-(page, head) scales; default: model dtype)")
    ap.add_argument("--metrics", action="store_true",
                    help="print the telemetry exit report (request latency "
                         "histograms, pool gauges, calibration fit)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="save a Chrome trace of the engine's iterations "
                         "(loadable at ui.perfetto.dev)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    cfg = dataclasses.replace(cfg, monarch=dataclasses.replace(
        cfg.monarch, backend="pallas"))
    print(f"arch={args.arch} (reduced: d={cfg.d_model}, L={cfg.n_layers}, "
          f"kind={cfg.layer_kind}, monarch={cfg.monarch.enable}) on {dev}")
    params = T.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator().manual_seed(1)
    reset_launches()

    if args.engine == "legacy" or cfg.layer_kind != "attn":
        if cfg.layer_kind != "attn" and args.engine == "continuous":
            print(f"({cfg.layer_kind} stack: falling back to ServeEngine)")
        engine = ServeEngine(cfg, params, max_len=64, device=dev)
        if args.quantize or args.fuse:
            from repro_torch.core.quant import BITS_BY_NAME
            from repro_torch.models.decode_path import prepare_decode_params

            engine.params = prepare_decode_params(
                engine.params, cfg, fuse=args.fuse,
                bits=BITS_BY_NAME.get(args.quantize))
        prompts = torch.randint(0, cfg.vocab, (args.requests, 12),
                                generator=gen)
        out = engine.generate(prompts, GenerationConfig(
            max_new_tokens=args.new_tokens, temperature=args.temperature))
        for b in range(out.shape[0]):
            print(f"req{b}: -> {out[b].tolist()}")
        print(f"kernel launches: {_launched()}")
        print("serve OK")
        return 0

    from repro_torch.core.quant import BITS_BY_NAME, KV_DTYPE_BYTES

    wbits = BITS_BY_NAME.get(args.quantize, 8)
    # the page width the engine will resolve (None = model dtype), so the
    # cost model prices the KV stream the pool actually serves
    kv_resolved = args.kv_dtype or (
        "bf16" if cfg.dtype == "bfloat16" else "fp32")
    kv_bits = int(8 * KV_DTYPE_BYTES[kv_resolved])
    cost = None
    if args.cost_model == "cim":
        cost = CIMCostModel(cfg, strategy="sparse", seq_len=128,
                            weight_bits=wbits, fused_proj=args.fuse,
                            kv_bits=kv_bits)
        print(f"CIM cost model: {cost.per_token_ns:.0f} ns/token, "
              f"{cost.per_token_nj:.0f} nJ/token (sparse mapping, "
              f"{wbits}-bit cells, {kv_bits}-bit KV stream)")

    max_len = 64 + args.system_prompt
    n_pages = None
    if args.preempt:
        # barely more than one worst-case request: concurrent sequences
        # fight for pages and the loser is evicted + resumed
        per_req = -(-(20 + args.system_prompt + args.new_tokens)
                    // args.page_size)
        n_pages = 1 + per_req + 1
    engine = ContinuousBatchingEngine(
        cfg, params, max_slots=args.max_slots, page_size=args.page_size,
        max_len=max_len, n_pages=n_pages, cost_model=cost,
        scheduler_cfg=SchedulerConfig(chunk_size=args.chunk_size,
                                      max_step_tokens=64),
        use_paged_kernel=args.paged_kernel,
        quantize=args.quantize, fuse_projections=args.fuse,
        prefix_sharing=not args.no_prefix_sharing,
        kv_dtype=args.kv_dtype, trace=args.trace_out, device=dev)
    if args.cost_model == "hbm":
        # weight traffic of the tree the engine serves (after fusion and
        # quantization), the KV stream at the stored page width
        engine.scheduler.cost_model = HBMCostModel.from_params(
            cfg, engine.params, kv_dtype=engine.kv_dtype)
    if args.quantize or args.fuse:
        from repro_torch.core.quant import tree_weight_bytes

        before, after = map(tree_weight_bytes, (params, engine.params))
        print(f"decode fast path: quantize={args.quantize} fuse={args.fuse} "
              f"(weights {before / 1e6:.1f} -> {after / 1e6:.1f} MB)")
        if args.quantize and after == before:
            print("  note: no Monarch factors in this tree — dense weights "
                  "pass through unquantized")

    sys_prompt = torch.randint(0, cfg.vocab, (args.system_prompt,),
                               generator=gen)
    finished = []
    for i in range(args.requests):
        plen = int(torch.randint(4, 20, (), generator=gen))
        prompt = torch.cat([sys_prompt, torch.randint(
            0, cfg.vocab, (plen,), generator=gen)]).numpy()
        engine.add_request(
            prompt,
            SamplingParams(max_new_tokens=args.new_tokens,
                           temperature=args.temperature, seed=i,
                           deadline_s=args.deadline_s),
            on_token=lambda r, t: print(
                f"  step {engine.step_idx:3d} req{r.req_id} += {t}"),
        )
        # staggered arrivals: one scheduler iteration per submit (short
        # requests can finish during the submission phase — keep them)
        finished.extend(engine.step())
        ps = engine.pool_host.stats()
        print(f"  step {engine.step_idx:3d} pool: "
              f"{ps.allocated_pages}/{ps.n_pages} pages allocated "
              f"({ps.shared_pages} shared, {ps.cached_pages} cached, "
              f"{ps.utilization * 100:.0f}% utilized), "
              f"{engine.stats['preemptions']} preemptions so far")

    finished.extend(engine.run())
    print(f"\nfinished {len(finished)} requests")
    for r in sorted(finished, key=lambda r: r.req_id):
        print(f"req{r.req_id}: prompt_len={r.prompt_len} "
              f"admitted@{r.admitted_step} done@{r.finished_step} "
              f"({r.finish_reason.value}) preempted={r.num_preemptions}x "
              f"-> {r.output_tokens}")
    s = engine.stats
    print(f"\nsteps={engine.step_idx} mixed_steps={s['mixed_steps']} "
          f"tokens_out={s['tokens_out']} decode_tokens={s['decode_tokens']} "
          f"prefill_tokens={s['prefill_tokens']} "
          f"preemptions={s['preemptions']}")
    print(f"aborted-family exits: aborts={s['aborts']} "
          f"timeouts={s['timeouts']} sheds={s['sheds']} "
          f"(degraded_chunks={s['degraded_chunks']})")
    ps = engine.pool_host.stats()
    print(f"pool at exit: {ps.allocated_pages}/{ps.n_pages} pages allocated, "
          f"{ps.free_pages} free, {ps.cached_pages} cached for reuse")
    print(f"pool bytes ({ps.kv_dtype} pages, {ps.page_bytes} B/page): "
          f"{ps.allocated_bytes / 1e3:.1f} of {ps.pool_bytes / 1e3:.1f} kB "
          f"physically pinned")
    # the high-water mark: what a capacity planner sizes the pool against
    print(f"pool high-water: {ps.peak_pages}/{ps.n_pages} pages "
          f"({ps.peak_bytes / 1e3:.1f} kB) at peak, "
          f"{ps.cache_evictions} LRU cache evictions")
    if args.system_prompt and not args.no_prefix_sharing:
        pool = engine.pool_host
        naive = sum(pool.pages_for(r.total_len) for r in finished)
        print(f"prefix sharing: {s['prefix_hit_tokens']} prefill tokens "
              f"skipped ({ps.prefix_hit_rate * 100:.0f}% of looked-up "
              f"tokens), {s['cow_forks']} COW forks, "
              f"{naive - pool.pages_allocated_total} of {naive} pages saved "
              f"({pool.pages_allocated_total} actually allocated)")
    if cost is not None and s["sim_latency_ns"]:
        print(f"simulated decode cost ({args.cost_model} model): "
              f"{s['sim_latency_ns']/1e3:.1f} us, "
              f"{s['sim_energy_nj']/1e3:.1f} uJ")
    if args.metrics:
        from repro_torch.serving import render_report

        print()
        print(render_report(engine.registry, [engine.calibration]))
        # requests aborted before their first token have no TTFT
        lat = [(r.req_id, r.ttft, r.queue_wait) for r in finished
               if r.ttft is not None and r.queue_wait is not None]
        print("per-request (ttft / queue wait, ms):")
        for rid, ttft, qw in sorted(lat):
            print(f"  req{rid}: {ttft * 1e3:7.2f} / {qw * 1e3:7.2f}")
    if args.trace_out:
        from repro_torch.serving import validate_trace

        n_ev = validate_trace(engine.tracer.to_json())
        print(f"wrote {engine.tracer.save()} ({n_ev} trace events — open "
              f"at https://ui.perfetto.dev)")
    engine.pool_host.check_invariants()
    print(f"kernel launches: {_launched()}")
    print("serve OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
