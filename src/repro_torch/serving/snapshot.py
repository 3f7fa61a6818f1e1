"""Engine snapshot/restore: rolling restarts for the serving engine (port
of ``repro.serving.snapshot``, the same snapshot form and the same on-disk
leaves, so that each package restores what the other saved).

``snapshot_engine`` freezes a ``ContinuousBatchingEngine`` into one dict --
after draining the in-flight dispatch chain, so the one-step harvest lag
never leaves a sampled token stranded on the device -- and
``restore_engine`` rebuilds a live engine from it.  Persistence goes
through ``checkpoint/store.py`` (atomic rename, per-leaf CRC32): device
tensors as checkpoint leaves, all host bookkeeping in the manifest's
``extra`` dict (JSON).

Recovery contract (what survives, what is recomputed, what is checked):

  * **Survives exactly** (full snapshot, ``include_kv=True``): request
    queues and order, emitted tokens, prefill cursors
    (``num_computed_tokens`` / ``num_cached_tokens``), per-sequence page
    tables, the prefix trie (structure, partial tails, LRU stamps), the
    device KV pages and int8 scales, per-slot sampling state (device
    token, temperature, PRNG keys, copy-on-write fork points).  Greedy AND
    sampled continuations are token-identical to an uninterrupted run.
  * **Recomputed on resume** (degraded restore, ``include_kv=False`` or a
    host-only snapshot): every unfinished request returns to WAITING with
    its cursor reset -- the preemption contract -- keeping emitted tokens
    and the PRNG ``resume_key`` captured at snapshot time, so outputs are
    still token-identical; only the KV recompute work is paid again.
  * **Restarts**: wall-clock lifecycle stamps.  ``deadline_s`` /
    ``max_queue_wait_s`` budgets are measured from the restore, and the
    metrics registry of a new engine starts fresh (``stats["restores"]``
    records the event).
  * **Checked on restore**: ``PagedKVPool.from_state`` re-derives
    refcounts from the page tables and runs ``check_invariants``, and
    ``faults.assert_recovery_invariants`` cross-checks engine against pool
    (no leaked reservations, exact slot accounting, each rank's KV heads)
    before the engine is handed back.
  * **Mesh-shape independent**: the pages leave through
    ``DeviceKV.export`` (every rank's heads gathered; a collective under a
    split pool, so every rank snapshots) and come back through
    ``DeviceKV.load`` (this rank's heads of the whole tree), so a tp = 2
    snapshot restores at tp = 1 and the reverse: pass ``mesh=`` in the
    restore's engine kwargs to pick the new placement.

What the port adds to that contract:

  * **In place.**  The restore copies device state into the engine's own
    tensors (``copy_``), never rebinds them: the engine's step and its
    captured CUDA graphs read and write the chained token, the keys, the
    temperatures and the pool in place, so a rebound tensor would never be
    read again.  :func:`restore_into` restores into an idle engine of the
    snapshot's geometry whose graphs are already captured; their replays
    then run on the restored state.
  * **Key words.**  The engine keeps each slot's PRNG key as two int32
    words; the snapshot's ``keys`` leaf is written as uint32, the
    reference's dtype, with the same bytes and CRC, and read back by
    reinterpreting the bits.
  * **After the harvest lag.**  A graph replay's sampled tokens are a
    clone taken after the replay on the same stream; the drain's read of
    them waits for that clone, and the device reads below follow it on
    the stream.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import (read_manifest, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving.faults import assert_recovery_invariants
from repro_torch.serving.kv_pool import PagedKVPool, SINK_PAGE
from repro_torch.serving.request import (FinishReason, Request, RequestState,
                                         SamplingParams, Sequence,
                                         reserve_req_ids)

SNAPSHOT_VERSION = 1

# constructor kwargs a snapshot's ``config`` section pins: callers must
# not override them on restore, and fleet tooling (``ReplicatedEngine``)
# strips them from shared engine kwargs before passing through
GEOMETRY_KEYS = ("max_slots", "page_size", "max_len", "n_pages",
                 "kv_dtype", "prefix_sharing", "chunk_size")


def engine_kwargs_from_config(c: dict) -> dict:
    """Constructor kwargs for an engine geometrically identical to the one
    a snapshot's ``config`` section describes (also how the replica router
    builds EMPTY engines of the fleet's geometry)."""
    return {k: c[k] for k in GEOMETRY_KEYS}


def _engine_config(engine) -> dict:
    return {
        "model": engine.cfg.name,
        "max_slots": int(engine.max_slots),
        "page_size": int(engine.page_size),
        "max_len": int(engine.max_len),
        "n_pages": int(engine.pool_host.n_pages),
        "kv_dtype": engine.kv_dtype,
        "prefix_sharing": bool(engine.prefix_sharing),
        "chunk_size": int(engine.scheduler.cfg.chunk_size),
    }


def _key_u32(key) -> np.ndarray:
    """A PRNG key's words as uint32, from the engine's int32 words or from
    a uint32 array."""
    if isinstance(key, torch.Tensor):
        key = key.cpu().numpy()
    key = np.asarray(key)
    return key.view(np.uint32) if key.dtype == np.int32 \
        else key.astype(np.uint32)


def _ser_request(req: Request, resume_key) -> dict:
    return {
        "req_id": int(req.req_id),
        "prompt": [int(t) for t in req.prompt],
        "output_tokens": [int(t) for t in req.output_tokens],
        "sampling": dataclasses.asdict(req.sampling),
        "state": req.state.name,
        "num_computed_tokens": int(req.num_computed_tokens),
        "num_cached_tokens": int(req.num_cached_tokens),
        "num_preemptions": int(req.num_preemptions),
        "resume_key": (None if resume_key is None
                       else [int(x) for x in
                             _key_u32(resume_key).reshape(-1)]),
        "arrived_step": int(req.arrived_step),
        "admitted_step": int(req.admitted_step),
        "finish_reason": (None if req.finish_reason is None
                          else req.finish_reason.value),
    }


def snapshot_engine(engine, include_kv: bool = True) -> dict:
    """Freeze the engine's complete serving state (see module docstring).
    Drains the dispatch chain first; requests the drain finishes surface
    through the engine's next ``step()``.  Under a mesh every rank calls
    it (the pages' export is a collective)."""
    engine._overflow.extend(engine.drain())
    keys_host = _key_u32(engine._keys)
    requests = []
    # finished-but-unreported requests (cancel()/drain completions waiting
    # in _overflow for the next step) are part of the serving state: a
    # crash between finish and report must not lose the completion
    for req in engine._overflow:
        requests.append(_ser_request(req, req.resume_key))
    for req in engine.waiting:
        requests.append(_ser_request(req, req.resume_key))
    running = []
    for slot, seq in sorted(engine.running.items()):
        # the per-slot PRNG stream IS the request's resume key: a degraded
        # restore re-admits through the preemption path and continues the
        # exact sampled stream
        requests.append(_ser_request(seq.request, keys_host[slot]))
        running.append({
            "req_id": int(seq.req_id),
            "slot": int(slot),
            "page_ids": [int(p) for p in seq.page_ids],
            "prefill_target": int(seq.prefill_target),
            "admit_order": int(seq.admit_order),
        })
    snap = {
        "version": SNAPSHOT_VERSION,
        "step_idx": int(engine.step_idx),
        "include_kv": bool(include_kv),
        "config": _engine_config(engine),
        "requests": requests,
        "waiting": [int(r.req_id) for r in engine.waiting],
        "running": running,
        "overflow": [int(r.req_id) for r in engine._overflow],
    }
    if include_kv:
        snap["pool_host"] = engine.pool_host.export_state()
        # host copies (never views of a CPU engine's live buffers);
        # DeviceKV.export gathers every rank's heads, so the form is the
        # same at every tp
        snap["device"] = {
            "kv": engine.kv.export(),
            "tok": engine._tok.to("cpu", copy=True),
            "keys": engine._keys.to("cpu", copy=True),
            "temp": engine._temp.to("cpu", copy=True),
            "wstart": torch.from_numpy(engine._wstart.copy()),
        }
    engine.stats["snapshots"] += 1
    return snap


def restore_into(eng, snap: dict) -> None:
    """Load a ``snapshot_engine`` dict into ``eng``, an idle engine of the
    snapshot's geometry, in place: device state is copied into the
    engine's own tensors, so a step graph it captured before replays on
    the restored state.  A full snapshot (``include_kv`` and a ``device``
    section) restores page tables, trie, KV pages and slot state exactly;
    otherwise every unfinished request re-enters WAITING and recomputes
    on resume, over an empty pool."""
    c = snap["config"]
    if eng.cfg.name != c["model"]:
        raise ValueError(
            f"snapshot is for model {c['model']!r}, got {eng.cfg.name!r}")
    mine = _engine_config(eng)
    for k in GEOMETRY_KEYS:
        if mine[k] != c[k]:
            raise ValueError(f"{k} is fixed by the snapshot: {c[k]!r}, "
                             f"the engine has {mine[k]!r}")
    if eng.has_work():
        raise ValueError("restore needs an idle engine")
    now = eng._clock()

    reqs: dict[int, Request] = {}
    max_id = -1
    for r in snap["requests"]:
        req = Request(prompt=list(r["prompt"]),
                      sampling=SamplingParams(**r["sampling"]),
                      req_id=int(r["req_id"]))
        req.output_tokens = list(r["output_tokens"])
        req.num_computed_tokens = r["num_computed_tokens"]
        req.num_cached_tokens = r["num_cached_tokens"]
        req.num_preemptions = r["num_preemptions"]
        if r["resume_key"] is not None:
            req.resume_key = np.asarray(r["resume_key"], np.uint32)
        req.arrived_step = r["arrived_step"]
        req.admitted_step = r["admitted_step"]
        req.state = RequestState[r["state"]]
        if r.get("finish_reason") is not None:
            req.finish_reason = FinishReason(r["finish_reason"])
        # lifecycle clocks restart at restore: the original process's
        # monotonic clock died with it, so deadlines and queue-wait budgets
        # are measured from here (see module docstring)
        req.t_arrival = req.t_enqueued = req.mark("restored", now)
        reqs[req.req_id] = req
        max_id = max(max_id, req.req_id)
    if max_id >= 0:
        reserve_req_ids(max_id)

    eng._pt[:] = SINK_PAGE
    eng._free_slots = list(range(eng.max_slots - 1, -1, -1))
    full = snap.get("include_kv") and snap.get("device") is not None
    if full:
        eng.pool_host = PagedKVPool.from_state(snap["pool_host"])
        # the restoring engine's mesh decides the KV split, not the
        # snapshot's: a tp = 2 snapshot restores at tp = 1 and the reverse
        eng.pool_host.kv_shard = eng.kv.kv_shard
        dev = snap["device"]
        eng.kv.load(dev["kv"])
        eng._tok.copy_(dev["tok"])
        eng._keys.copy_(dev["keys"])
        eng._temp.copy_(dev["temp"])
        eng._temp_host[:] = dev["temp"].numpy()
        eng._wstart[:] = dev["wstart"].numpy()
        max_order = -1
        for rec in snap["running"]:
            req = reqs[rec["req_id"]]
            seq = Sequence(request=req, slot=rec["slot"],
                           page_ids=[int(p) for p in rec["page_ids"]],
                           prefill_target=rec["prefill_target"],
                           admit_order=rec["admit_order"], t_admitted=now)
            eng.running[seq.slot] = seq
            eng._pt[seq.slot, :len(seq.page_ids)] = seq.page_ids
            max_order = max(max_order, seq.admit_order)
        eng._free_slots = [s for s in range(eng.max_slots - 1, -1, -1)
                           if s not in eng.running]
        eng._admit_stamp = itertools.count(max_order + 1)
        for rid in snap["waiting"]:
            eng.waiting.append(reqs[rid])
    else:
        # degraded restore: no KV -- an empty pool, and every unfinished
        # request re-enters WAITING through the preemption contract
        # (cursor reset, emitted tokens + PRNG stream kept), residents
        # first in admission order
        p = eng.pool_host
        eng.pool_host = PagedKVPool(p.n_pages, p.page_size,
                                    p.max_pages_per_seq, kv_dtype=p.kv_dtype,
                                    page_bytes=p.page_bytes,
                                    kv_shard=p.kv_shard)
        order = sorted(snap["running"], key=lambda r: r["admit_order"])
        resident = [reqs[r["req_id"]] for r in order]
        queued = [reqs[rid] for rid in snap["waiting"]]
        for req in resident + queued:
            req.state = RequestState.WAITING
            req.num_computed_tokens = 0
            req.num_cached_tokens = 0
            eng.waiting.append(req)

    # finished-but-unreported completions surface through the restored
    # engine's first step(), exactly as they would have before the crash
    eng._overflow.extend(reqs[rid] for rid in snap.get("overflow", ()))
    eng.step_idx = snap["step_idx"]
    eng.stats["restores"] += 1
    assert_recovery_invariants(eng)


def restore_engine(snap: dict, cfg, params, **engine_kw):
    """Build an engine of the snapshot's geometry and :func:`restore_into`
    it.  Extra ``engine_kw`` (device, mesh, cost_model, metrics,
    fault_injector, ...) pass through to the constructor; geometry kwargs
    come from the snapshot and must not be overridden."""
    from repro_torch.serving.engine import ContinuousBatchingEngine

    c = snap["config"]
    if cfg.name != c["model"]:
        raise ValueError(
            f"snapshot is for model {c['model']!r}, got {cfg.name!r}")
    for k in GEOMETRY_KEYS:
        if k in engine_kw:
            raise ValueError(f"{k} is fixed by the snapshot")
    eng = ContinuousBatchingEngine(
        cfg, params, **engine_kwargs_from_config(c), **engine_kw)
    restore_into(eng, snap)
    return eng


def save_snapshot(directory, snap: dict, keep_last: int = 3):
    """Persist a snapshot through the checkpoint store: device tensors as
    CRC-checked leaves (the keys as uint32 words), everything else in the
    manifest's ``extra``."""
    dev = snap.get("device")
    state = {} if dev is None else {**dev, "keys": _key_u32(dev["keys"])}
    extra = {k: v for k, v in snap.items() if k != "device"}
    return save_checkpoint(directory, snap["step_idx"], state,
                           keep_last=keep_last, extra=extra)


def _pool_like(cfg, c: dict) -> dict:
    """Meta tensors of the exported pool's shapes and dtypes (every KV
    head): the template of a snapshot's ``kv`` leaves, nothing allocated."""
    one = L.paged_cache_init(cfg, c["n_pages"], c["page_size"],
                             T._dtype(cfg), kv_dtype=c["kv_dtype"],
                             device="meta")
    return {"layers": {"attn": {
        name: a.new_empty((cfg.n_layers, *a.shape)) for name, a in one.items()
    }}}


def load_snapshot(directory, cfg, step: Optional[int] = None) -> dict:
    """Load a persisted snapshot (the newest, unless ``step``) back into
    ``restore_engine`` form, its device leaves as CPU tensors.  The
    manifest's host state describes the device tree's geometry, so the
    leaves' template is built from it (and every leaf's CRC32 is
    verified)."""
    manifest = read_manifest(directory, step)
    snap = dict(manifest["extra"])
    if snap.get("include_kv"):
        c = snap["config"]
        S = c["max_slots"]

        def meta(*shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")

        like = {"kv": _pool_like(cfg, c), "tok": meta(S),
                "keys": meta(S, 2), "temp": meta(S, dtype=torch.float32),
                "wstart": meta(S)}
        state, _ = restore_checkpoint(directory, manifest["step"], like)
        snap["device"] = state
    return snap


__all__ = ["snapshot_engine", "restore_engine", "restore_into",
           "save_snapshot", "load_snapshot", "engine_kwargs_from_config",
           "GEOMETRY_KEYS", "SNAPSHOT_VERSION"]
