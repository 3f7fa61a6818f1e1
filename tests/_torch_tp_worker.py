"""Rank side of the port's tensor-parallel CPU tests.

``launch.mesh.run_ranks`` starts each rank as a fresh process that
imports this module by name, so it imports ``torch`` and ``repro_torch``
only: no JAX in the ranks.  Each rank function runs on one CPU thread,
so a world of ranks does not oversubscribe the test workers' cores.
``drive`` runs one request trace through any engine with the
``ContinuousBatchingEngine`` API, so the test process drives the JAX
reference's tp = 1 engine with the same code.
"""

from __future__ import annotations

import time

import numpy as np
import torch

STAT_KEYS = ("mixed_steps", "decode_tokens", "prefill_tokens", "tokens_out",
             "preemptions", "prefix_hit_tokens", "cow_forks",
             "kernel_dispatches", "dense_fallbacks",
             "dense_fallback_gqa_replicated", "dense_fallback_disabled",
             "aborts", "timeouts", "sheds", "finished")


def drive(eng, sampling_cls, trace: dict) -> list[list[int]]:
    """Serve ``trace`` (``prompts``, ``max_new``; ``first``: a request
    served alone before the others arrive) to the end; returns every
    request's tokens in arrival order."""
    sp = sampling_cls(max_new_tokens=trace["max_new"], temperature=0.0)
    reqs = []
    if trace.get("first") is not None:
        reqs.append(eng.add_request(trace["first"], sampling=sp))
        while eng.has_work():
            eng.step()
    reqs += [eng.add_request(p, sampling=sp) for p in trace["prompts"]]
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
        assert steps < 2000, "engine did not converge"
    return [list(r.output_tokens) for r in reqs]


def drive_clock(eng, sampling_cls, trace: dict, rank: int) -> list:
    """Serve a trace whose outcome reads the clock, on one rank, on two
    slots.  Request 0 runs and is cancelled after step ``cancel_at``; 1
    runs and 3 waits, both with ``deadline_s = limit_s``; 2 takes 0's slot
    and runs to its end; 4 and 5 wait with ``max_queue_wait_s =
    limit_s``.  After step ``pause_at`` rank 0 ALONE sleeps ``pause_s`` >
    ``limit_s``, so only rank 0's broadcast clock can make the other
    ranks decide as it does: at the next step 1 and 3 time out, 4 takes
    1's slot (a request the step admits is never shed) and 5, left
    waiting, is shed.  Request 6 arrives after the pause and runs to its
    end.  Returns each request's (finish reason, tokens)."""
    lim, p = trace["limit_s"], trace["prompts"]
    limits = [{}, {"deadline_s": lim}, {}, {"deadline_s": lim},
              {"max_queue_wait_s": lim}, {"max_queue_wait_s": lim}]
    reqs = [eng.add_request(p[i], sampling_cls(
        max_new_tokens=trace["max_new"], temperature=0.0, **kw))
        for i, kw in enumerate(limits)]
    for step in range(1, trace["pause_at"] + 1):
        eng.step()
        if step == trace["cancel_at"]:
            assert eng.cancel(reqs[0].req_id)
    if rank == 0:
        time.sleep(trace["pause_s"])
    reqs.append(eng.add_request(p[6], sampling_cls(
        max_new_tokens=trace["max_new"], temperature=0.0)))
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
        assert steps < 2000, "engine did not converge"
    return [(r.finish_reason.value, list(r.output_tokens)) for r in reqs]


def serve_jobs(mesh, jobs: dict) -> dict:
    """Each job ``(cfg, numpy params, traces, step)`` on this rank: every
    trace through a tensor-parallel engine (tokens, counters, pool facts,
    ``check_shards``; a trace with ``export`` also gathers its pool to the
    host and round-trips it through ``load``; a trace with ``limit_s``
    goes through ``drive_clock``), and with ``step`` one
    ``paged_mixed_step`` on the sharded params and pool (its logits)."""
    import sys

    torch.set_num_threads(1)

    from repro_torch.convert import params_from_numpy
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serving import ContinuousBatchingEngine, SamplingParams

    out = {"rank": mesh.rank}
    for job, (cfg, np_params, traces, step) in jobs.items():
        params = params_from_numpy(np_params, device="cpu")
        res = out[job] = {}
        for name, tr in traces.items():
            eng = ContinuousBatchingEngine(cfg, params, mesh=mesh,
                                           **tr["engine"])
            reset_launches()
            if "limit_s" in tr:
                tokens = drive_clock(eng, SamplingParams, tr, mesh.rank)
            else:
                tokens = drive(eng, SamplingParams, tr)
            eng.pool_host.check_invariants()
            eng.kv.check_shards()
            ps = eng.pool_host.stats()
            attn = eng.params["decoder"]["layers"]["attn"]
            res[name] = {
                "tokens": tokens,
                "stats": {k: eng.stats[k] for k in STAT_KEYS},
                "launches": launches(),
                "tp": eng.tp, "kv_shard": eng.kv.kv_shard,
                "n_pages": eng.pool_host.n_pages,
                "pool_kv_shard": ps.kv_shard,
                "page_bytes": ps.page_bytes,
                "shard_page_bytes": ps.shard_page_bytes,
                "local_heads": {
                    k: int(v.shape[3 if v.ndim == 5 else 2])
                    for k, v in eng.pool["layers"]["attn"].items()},
                "local_out": {k: _out_width(v) for k, v in attn.items()},
                "ffn_out": {k: _out_width(v) for k, v in
                            eng.params["decoder"]["layers"]["ffn"].items()},
            }
            if tr.get("export"):
                res[name]["export"] = _export(eng, mesh, cfg, tr)
        if step is not None:
            res["step_logits"] = _step(mesh, cfg, params, step)
    out["jax_or_reference_loaded"] = sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
    return out


def _out_width(lin: dict) -> int:
    """A (stacked) linear's output width on this rank: Monarch ``R`` or
    quantized ``Rq`` (q, s, k), or dense ``w``."""
    r = lin.get("R", lin.get("Rq"))
    return int(r.shape[-3] * r.shape[-2]) if r is not None else int(
        lin["w"].shape[-1])


def _export(eng, mesh, cfg, tr) -> dict:
    from repro_torch.serving.device_kv import DeviceKV

    full = eng.kv.export()
    kv = DeviceKV(cfg, eng.kv.n_pages, eng.page_size,
                  kv_dtype=tr["engine"].get("kv_dtype"), plan=eng.plan,
                  device="cpu")
    kv.load(full)
    kv.check_shards()
    again = kv.export()
    local = eng.pool["layers"]["attn"]
    return {
        "pool": full,
        "round_trip": all(torch.equal(full["layers"]["attn"][k],
                                      again["layers"]["attn"][k])
                          for k in full["layers"]["attn"]),
        "local_equals_slice": all(
            torch.equal(local[k], kv.pool["layers"]["attn"][k])
            for k in local),
    }


def _step(mesh, cfg, params, step: dict) -> torch.Tensor:
    """One mixed step (numpy inputs ``tokens``, ``start``, ``span``,
    ``table``, ``n_pages``, ``page_size``) on this rank's shards."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.device_kv import DeviceKV
    from repro_torch.sharding.params import shard_params, tp_plan

    plan = tp_plan(params, cfg, mesh)
    kv = DeviceKV(cfg, step["n_pages"], step["page_size"], plan=plan,
                  device="cpu")
    logits, _ = T.paged_mixed_step(
        shard_params(params, plan), torch.from_numpy(step["tokens"]),
        torch.from_numpy(step["start"]), torch.from_numpy(step["span"]),
        torch.from_numpy(step["table"]), kv.pool, cfg, plan=plan)
    return logits


def snapshot_across_meshes(mesh, job: dict) -> dict:
    """The engine snapshot across meshes, on this rank: restore the tp = 1
    snapshot under ``tp1_dir`` at this mesh's tp and serve it to the end
    (every request's tokens, by request id); then serve ``prompts`` afresh
    for ``steps`` steps and save the tp = 2 snapshot under ``tp2_dir``
    (rank 0 writes it, every rank exports its heads)."""
    import sys

    torch.set_num_threads(1)

    from repro_torch.convert import params_from_numpy
    from repro_torch.serving import ContinuousBatchingEngine, SamplingParams

    cfg = job["cfg"]
    params = params_from_numpy(job["params"], device="cpu")
    eng = ContinuousBatchingEngine.restore_latest(job["tp1_dir"], cfg,
                                                  params, mesh=mesh)
    kv_shard = eng.kv.kv_shard
    done = {r.req_id: list(r.output_tokens) for r in eng.run()}
    eng = ContinuousBatchingEngine(cfg, params, mesh=mesh, **job["geom"])
    reqs = [eng.add_request(p, SamplingParams(**sp))
            for p, sp in zip(job["prompts"], job["sampling"])]
    for _ in range(job["steps"]):
        eng.step()
    eng.save_snapshot(job["tp2_dir"])
    return {"rank": mesh.rank, "kv_shard": kv_shard,
            "restored_tp1_tokens": [done[k] for k in sorted(done)],
            "tp2_req_ids": [r.req_id for r in reqs],
            "jax_or_reference_loaded": sorted(
                m for m in sys.modules if m.split(".")[0] in ("jax",
                                                               "repro"))}


def faults_on_mesh(mesh, job: dict) -> dict:
    """``job["schedule"]`` (step, kind, kw) armed on this rank's own
    ``FaultInjector`` (every rank receives the same calls), then the
    trace served to the end: each request's finish reason and tokens,
    the injector's log and the engine's recovery counters."""
    torch.set_num_threads(1)

    from repro_torch.convert import params_from_numpy
    from repro_torch.serving import (ContinuousBatchingEngine,
                                     FaultInjector, SamplingParams,
                                     assert_recovery_invariants)

    return run_faults(
        ContinuousBatchingEngine, FaultInjector, SamplingParams,
        assert_recovery_invariants, job,
        params=params_from_numpy(job["params"], device="cpu"), mesh=mesh)


def run_faults(engine_cls, injector_cls, sampling_cls, check, job: dict,
               **engine_kw) -> dict:
    """Serve ``job``'s trace under its fault schedule through any engine
    with the ``ContinuousBatchingEngine`` API (the test process drives
    tp = 1 engines with the same code)."""
    fi = injector_cls()
    for step, kind, kw in job["schedule"]:
        fi.schedule(step, kind, **kw)
    eng = engine_cls(job["cfg"], engine_kw.pop("params"),
                     fault_injector=fi, **job["geom"], **engine_kw)
    reqs = [eng.add_request(p, sampling_cls(**sp))
            for p, sp in zip(job["prompts"], job["sampling"])]
    steps = 0
    while eng.has_work():
        eng.step()
        check(eng)
        steps += 1
        assert steps < 2000, "engine did not converge"
    fi.release_all(eng)
    return {"reasons": [r.finish_reason.value for r in reqs],
            "tokens": [list(r.output_tokens) for r in reqs],
            "log": [list(e) for e in fi.log],
            "stats": {k: eng.stats[k] for k in (
                "dispatch_failures", "preemptions", "timeouts")}}


def qrow_inputs():
    """x (3, 64) and a Monarch pair L (4, 4, 16), R (4, 16, 4), seeded."""
    g = torch.Generator().manual_seed(0)
    return (torch.randn(3, 64, generator=g), torch.randn(4, 4, 16, generator=g),
            torch.randn(4, 16, 4, generator=g))


def collectives(mesh) -> dict:
    """One of each collective on rank-dependent values, and a
    row-parallel quantized linear (int8 and int4: this rank's slices of
    the whole quantized pair, its input columns, one all-reduce)."""
    from repro_torch.core.linear import linear_apply
    from repro_torch.core.quant import quantize_monarch
    from repro_torch.sharding import api
    from repro_torch.sharding.params import TPPlan, shard_params

    torch.set_num_threads(1)

    r = mesh.rank
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
    out = {
        "sum": api.all_reduce_sum(x, mesh),
        "sum_bf16": api.all_reduce_sum(x.to(torch.bfloat16), mesh),
        "gather": api.all_gather_cat(x, mesh, dim=-1),
        "time": api.broadcast_time(100.0 + r, mesh),
        "x": x,
    }
    xq, L, R = qrow_inputs()
    cols = xq.shape[-1] // mesh.model
    for bits in (8, 4):
        tree = {"attn": {"wo": quantize_monarch({"L": L, "R": R}, bits)}}
        local = shard_params(tree, TPPlan(mesh, heads=True))["attn"]["wo"]
        out[f"qrow{bits}"] = linear_apply(
            local, xq[:, r * cols:(r + 1) * cols], reduce=mesh)
    return out


def fail_on_rank_one(mesh) -> None:
    """Rank 1 fails before its first collective; rank 0 waits in one."""
    torch.set_num_threads(1)
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    from repro_torch.sharding import api

    api.all_reduce_sum(torch.ones(2), mesh)


def sleep_long(mesh) -> None:
    """Every rank sleeps past any test's patience: only a stop ends it."""
    time.sleep(300)


def prompts(vocab: int, n: int, lo: int = 8, hi: int = 14,
            seed: int = 0) -> list[list[int]]:
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(1, vocab - 1, rng.randint(lo, hi))))
            for _ in range(n)]
