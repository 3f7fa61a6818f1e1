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
                "local_out": {k: int(v["R"].shape[-3] * v["R"].shape[-2])
                              if "R" in v else int(v["w"].shape[-1])
                              for k, v in attn.items()},
            }
            if tr.get("export"):
                res[name]["export"] = _export(eng, mesh, cfg, tr)
        if step is not None:
            res["step_logits"] = _step(mesh, cfg, params, step)
    out["jax_or_reference_loaded"] = sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
    return out


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


def collectives(mesh) -> dict:
    """One of each collective on rank-dependent values."""
    from repro_torch.sharding import api

    torch.set_num_threads(1)

    r = mesh.rank
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
    return {
        "sum": api.all_reduce_sum(x, mesh),
        "sum_bf16": api.all_reduce_sum(x.to(torch.bfloat16), mesh),
        "gather": api.all_gather_cat(x, mesh, dim=-1),
        "time": api.broadcast_time(100.0 + r, mesh),
        "x": x,
    }


def fail_on_rank_one(mesh) -> None:
    """Rank 1 fails before its first collective; rank 0 waits in one."""
    torch.set_num_threads(1)
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    from repro_torch.sharding import api

    api.all_reduce_sum(torch.ones(2), mesh)


def prompts(vocab: int, n: int, lo: int = 8, hi: int = 14,
            seed: int = 0) -> list[list[int]]:
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(1, vocab - 1, rng.randint(lo, hi))))
            for _ in range(n)]
