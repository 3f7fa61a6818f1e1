"""Rank side of ``tests/test_torch_tp_families.py``: the mixture-of-experts,
encoder-decoder, vision, Mamba2 and hybrid stacks under tensor
parallelism.

``launch.mesh.run_ranks`` starts each rank as a fresh process that imports
this module by name, so it imports ``torch`` and ``repro_torch`` only.
Each rank runs on one CPU thread.  :func:`run_jobs` with ``mesh=None`` is
the port's tp = 1 run of the same jobs, which the test process makes
itself.

A job is a dict with ``kind``:

* ``"engine"``: the continuous-batching engine (``engine`` kwargs) over
  ``prompts``, greedy, ``max_new`` tokens each: the tokens, the counters,
  and the routes of every MoE call; then one mixed step (``step``: numpy
  ``tokens``, ``start``, ``span``, ``table``, ``n_pages``, ``page_size``)
  on the sharded params and pool: its logits and routes; and this rank's
  expert leaves;
* ``"steps"``: ``launch.steps.make_prefill_step`` on ``tokens`` (and
  ``enc_embeds`` / ``patch_embeds``), then, unless ``new`` is 0, the
  prompt token by token through ``make_decode_step`` into the decode
  cache and ``new`` greedy tokens: every decode logits, the tokens and
  the final cache's Mamba states and rings.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch


@contextlib.contextmanager
def recording_routes(into: list):
    """Every ``moe_apply`` call's route, in call order: its top-k slots
    and the kept (token, slot) pairs after capacity (``layers._route`` and
    ``layers._dispatch`` wrapped for the block)."""
    from repro_torch.models import layers as L

    route, dispatch = L._route, L._dispatch

    def rec_route(logits, mc):
        out = route(logits, mc)
        into.append({"idx": out[2].clone()})
        return out

    def rec_dispatch(idx, gates, E, cap, dtype):
        d, c = dispatch(idx, gates, E, cap, dtype)
        into[-1]["kept"] = d.float().sum(-1) > 0
        return d, c

    L._route, L._dispatch = rec_route, rec_dispatch
    try:
        yield into
    finally:
        L._route, L._dispatch = route, dispatch


def _plan(cfg, params, mesh):
    from repro_torch.sharding.params import shard_params, tp_plan

    if mesh is None:
        return None, params
    plan = tp_plan(params, cfg, mesh)
    return plan, shard_params(params, plan)


def _engine_job(mesh, job: dict) -> dict:
    from repro_torch.convert import params_from_numpy
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import transformer as T
    from repro_torch.serving import ContinuousBatchingEngine, SamplingParams
    from repro_torch.serving.device_kv import DeviceKV

    cfg = job["cfg"]
    params = params_from_numpy(job["params"], device="cpu")
    kw = {} if mesh is not None else {"device": "cpu"}
    eng = ContinuousBatchingEngine(cfg, params, mesh=mesh, **job["engine"],
                                   **kw)
    sp = SamplingParams(max_new_tokens=job["max_new"], temperature=0.0)
    reset_launches()
    routes: list = []
    with recording_routes(routes):
        reqs = [eng.add_request(p, sp) for p in job["prompts"]]
        steps = 0
        while eng.has_work():
            eng.step()
            steps += 1
            assert steps < 2000, "engine did not converge"
    eng.pool_host.check_invariants()
    eng.kv.check_shards()
    layers = eng.params["decoder"]["layers"]
    out = {"tokens": [list(r.output_tokens) for r in reqs],
           "stats": {k: eng.stats[k] for k in (
               "mixed_steps", "kernel_dispatches", "dense_fallbacks",
               "dense_fallback_gqa_replicated")},
           "launches": launches(), "routes": routes,
           "kv_shard": eng.kv.kv_shard,
           "experts": layers["moe"]["experts"] if "moe" in layers else None}
    st = job.get("step")
    if st is not None:
        # one mixed step on the rank's shards of the same prepared tree
        plan = eng.plan
        kv = DeviceKV(cfg, st["n_pages"], st["page_size"], plan=plan,
                      device="cpu")
        step_routes: list = []
        with recording_routes(step_routes):
            logits, _ = T.paged_mixed_step(
                eng.params, torch.from_numpy(st["tokens"]),
                torch.from_numpy(st["start"]), torch.from_numpy(st["span"]),
                torch.from_numpy(st["table"]), kv.pool, eng.cfg, plan=plan)
        out.update(step_logits=logits, step_routes=step_routes)
    return out


def _states(cache: dict) -> dict:
    """The decode cache's leaves but ``pos``, by ``/``-joined path."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            elif k != "pos":
                out[path] = v.clone()

    walk(cache, "")
    return out


def _steps_job(mesh, job: dict) -> dict:
    from repro_torch.convert import params_from_numpy
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.steps import (_compute_cast, make_decode_step,
                                          make_prefill_step)
    from repro_torch.models import transformer as T

    cfg = job["cfg"]
    plan, params = _plan(cfg, params_from_numpy(job["params"], device="cpu"),
                         mesh)
    toks = torch.from_numpy(job["tokens"])
    batch = {"tokens": toks}
    for k in ("enc_embeds", "patch_embeds"):
        if k in job:
            batch[k] = torch.from_numpy(job[k])
    reset_launches()
    out = {"prefill": make_prefill_step(cfg, plan)(params, batch)}
    if not job["new"]:
        out["launches"] = launches()
        return out
    enc_out = None
    if cfg.encdec:
        enc_out = T._encode(_compute_cast(params, cfg), batch, cfg,
                            plan=plan)
        out["enc_out"] = enc_out
    B, S = toks.shape
    step = make_decode_step(cfg, plan)
    cache = T.init_decode_cache(cfg, B, S + job["new"], device="cpu",
                                plan=plan)
    logits = []
    for t in range(S):
        lg, _ = step(params, toks[:, t].contiguous(), cache, enc_out)
        logits.append(lg)
    new = []
    for i in range(job["new"]):
        tok = torch.argmax(lg[:, :cfg.vocab], dim=-1).to(torch.int32)
        new.append(tok)
        if i < job["new"] - 1:
            lg, _ = step(params, tok, cache, enc_out)
            logits.append(lg)
    out.update(logits=logits, tokens=torch.stack(new, 1).tolist(),
               states=_states(cache), launches=launches())
    return out


def run_jobs(mesh, jobs: dict) -> dict:
    """Every job on this rank (``mesh=None``: the port's tp = 1 run, in
    the calling process at its own thread count)."""
    if mesh is not None:
        torch.set_num_threads(1)
    run = {"engine": _engine_job, "steps": _steps_job}
    out = {name: run[job["kind"]](mesh, job) for name, job in jobs.items()}
    out["rank"] = 0 if mesh is None else mesh.rank
    out["jax_or_reference_loaded"] = sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
    return out


def prompts(vocab: int, n: int, lo: int, hi: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]
