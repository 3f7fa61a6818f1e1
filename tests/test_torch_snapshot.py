"""Engine snapshot/restore of the port (``serving.snapshot``,
``checkpoint.store``) against the JAX reference, on the CPU.

* Counterparts of ``tests/test_snapshot.py``: pool state round trips,
  snapshots mid-prefill and mid-decode (a harvest pending) restored to
  token-identical greedy and sampled continuations, degraded (no-KV)
  restores, the CRC-checked on-disk round trip, and the supervisor's
  recovery -- every port run's tokens held to the reference engine's
  uninterrupted run on the same seeded params (``convert.params_from_numpy``).
* Across packages, through the shared on-disk layout: a snapshot the
  reference wrote (greedy, sampled, int8 KV, a bf16 pool) restored by the
  port, and the port's fp32 and int8 snapshots restored by the reference,
  each continuing with the reference's uninterrupted tokens; both packages
  snapshot the same trace at the same step into the same leaf ids, shapes,
  dtypes and manifest ``extra``, the KV leaves within fp32 2e-5, the PRNG
  keys as the same uint32 words.
* The port's own contract: a save cut before its rename leaves the latest
  step intact; a restore into an engine whose step graphs are captured
  keeps every device buffer (``data_ptr``) and replays on the restored
  state; a tp = 2 snapshot restores at tp = 1 and the reverse (gloo ranks
  on the CPU, ``tests/_torch_tp_worker.py``)."""

import dataclasses
import functools
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_tp_worker as W
import repro.serving as js
import repro_torch.serving as ts
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import tree_map
from repro_torch.checkpoint import latest_step, save_checkpoint
from repro_torch.checkpoint import store
from repro_torch.convert import params_from_numpy
from repro_torch.ft.coordinator import EngineSupervisor
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.config import ModelConfig
from repro_torch.serving import (ContinuousBatchingEngine, FinishReason,
                                 PagedKVPool, SamplingParams,
                                 assert_recovery_invariants)
from repro_torch.serving.request import reserve_req_ids
from repro_torch.serving.snapshot import (load_snapshot, restore_engine,
                                          restore_into, save_snapshot)
from test_torch_step_graphs import _with_host_graphs

FIELDS = dict(name="t", d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
              d_ff=128, vocab=256, dtype="float32")
CFG = ModelConfig(**FIELDS)
JCFG = JModelConfig(**FIELDS)

PROMPTS = [list(range(5, 15)), list(range(30, 38)), [7, 9, 11]]
GEOM = dict(max_slots=4, page_size=8, max_len=128)
KV_TOL = 2e-5


@pytest.fixture(scope="module")
def params():
    """(reference params, the port's copy of them on the CPU)."""
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


def _engine(params, **kw):
    return ContinuousBatchingEngine(CFG, params[1], device="cpu",
                                    **{**GEOM, **kw})


def _jengine(params, **kw):
    return js.ContinuousBatchingEngine(JCFG, params[0], **{**GEOM, **kw})


def _greedy(i):
    return dict(max_new_tokens=8)


def _sampled(i):
    return dict(max_new_tokens=8, temperature=0.8, seed=i)


def _mixed(i):
    return dict(max_new_tokens=8, temperature=0.5 if i == 1 else 0.0,
                seed=i)


@functools.lru_cache(maxsize=None)
def _reference_tokens(sampling: str, kv_dtype=None) -> list:
    """The reference engine's uninterrupted tokens on PROMPTS."""
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    eng = js.ContinuousBatchingEngine(JCFG, jp, kv_dtype=kv_dtype, **GEOM)
    fn = globals()[sampling]
    reqs = [eng.add_request(p, js.SamplingParams(**fn(i)))
            for i, p in enumerate(PROMPTS)]
    eng.run()
    return [list(r.output_tokens) for r in reqs]


def _add_all(eng, pk, sampling: str) -> list:
    fn = globals()[sampling]
    return [eng.add_request(p, pk.SamplingParams(**fn(i)))
            for i, p in enumerate(PROMPTS)]


def _finish(eng, reqs) -> list:
    fin = {r.req_id: r for r in eng.run()}
    return [list(fin[r.req_id].output_tokens) for r in reqs]


# ---------------------------------------------------------------------------
# pool export / from_state
# ---------------------------------------------------------------------------


def test_pool_state_roundtrip_plain():
    pools = {}
    for name, cls in (("torch", PagedKVPool), ("jax", js.PagedKVPool)):
        pool = pools[name] = cls(n_pages=9, page_size=4)
        pool.allocate(1, 10)
        pool.allocate(2, 4)
        pool.free(2)
    pool = pools["torch"]
    clone = PagedKVPool.from_state(pool.export_state())
    clone.check_invariants()
    assert clone.page_table(1) == pool.page_table(1)
    assert clone.free_pages == pool.free_pages
    assert sorted(clone._free) == sorted(pool._free)
    assert pool.export_state() == pools["jax"].export_state()


def test_pool_state_roundtrip_shared_trie_and_partials():
    """Shared full pages, a partial tail and a COW fork survive the
    export: refcounts are recomputed, and the state is the reference's."""
    toks = list(range(100, 110))            # 2.5 pages
    states = {}
    for name, cls in (("torch", PagedKVPool), ("jax", js.PagedKVPool)):
        pool = cls(n_pages=17, page_size=4)
        pool.acquire_prefix(1, toks)
        pool.extend(1, 10)
        pool.advance(1, 10)
        pool.commit_prefix(1, toks, 10)
        pool.acquire_prefix(2, toks)
        pool.free(1)
        states[name] = (pool, pool.export_state())
    pool, state = states["torch"]
    assert state == states["jax"][1]
    clone = PagedKVPool.from_state(state)
    clone.check_invariants()
    assert clone.page_table(2) == pool.page_table(2)
    assert clone.free_pages == pool.free_pages
    m_old, m_new = pool.match_prefix(toks), clone.match_prefix(toks)
    assert (m_new.n_tokens, m_new.pages, m_new.cow) == \
        (m_old.n_tokens, m_old.pages, m_old.cow)
    assert clone.prefix_hit_tokens == pool.prefix_hit_tokens
    assert clone.cow_forks == pool.cow_forks


def test_pool_state_is_json_safe():
    pool = PagedKVPool(n_pages=9, page_size=4)
    pool.acquire_prefix(5, list(range(9)))
    pool.extend(5, 9)
    pool.advance(5, 9)
    pool.commit_prefix(5, list(range(9)), 9)
    clone = PagedKVPool.from_state(json.loads(json.dumps(
        pool.export_state())))
    clone.check_invariants()
    assert clone.page_table(5) == pool.page_table(5)


# ---------------------------------------------------------------------------
# engine snapshot / restore (in memory)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [1, 3, 6])
def test_full_restore_token_identical_greedy(params, steps):
    """Snapshots mid-prefill (1 step) and mid-decode (3, 6), a harvest
    pending each time, restore to the reference's greedy streams."""
    eng = _engine(params)
    reqs = _add_all(eng, ts, "_greedy")
    for _ in range(steps):
        eng.step()
    snap = eng.snapshot()
    assert eng.stats["snapshots"] == 1
    restored = ContinuousBatchingEngine.restore(snap, CFG, params[1],
                                                device="cpu")
    assert restored.stats["restores"] == 1
    assert _finish(restored, reqs) == _reference_tokens("_greedy")
    assert_recovery_invariants(restored)


def test_full_restore_token_identical_sampled(params):
    """Per-slot PRNG keys are part of the snapshot: sampled streams
    continue exactly."""
    eng = _engine(params)
    reqs = _add_all(eng, ts, "_sampled")
    for _ in range(3):
        eng.step()
    restored = ContinuousBatchingEngine.restore(eng.snapshot(), CFG,
                                                params[1], device="cpu")
    assert _finish(restored, reqs) == _reference_tokens("_sampled")


def test_degraded_restore_recomputes_token_identical(params):
    """A no-KV snapshot: everyone re-enters WAITING and recomputes, greedy
    and sampled alike, to the same tokens."""
    eng = _engine(params)
    reqs = _add_all(eng, ts, "_mixed")
    eng.step()
    eng.step()
    snap = eng.snapshot(include_kv=False)
    assert "device" not in snap and "pool_host" not in snap
    restored = ContinuousBatchingEngine.restore(snap, CFG, params[1],
                                                device="cpu")
    assert not restored.running and restored.waiting
    assert _finish(restored, reqs) == _reference_tokens("_mixed")


def test_snapshot_preserves_shared_cow_pages(params):
    """Requests sharing a prefix (COW forks live) snapshot and restore with
    the sharing intact, to the reference's tokens."""
    sysp = list(range(50, 70))   # 2.5 pages at page_size 8
    prompts = [sysp + [100 + i] for i in range(3)]

    def warmed(make, pk):
        eng = make(params)
        eng.add_request(list(sysp), pk.SamplingParams(max_new_tokens=2))
        eng.run()
        return eng

    ref_eng = warmed(_jengine, js)
    ref_reqs = [ref_eng.add_request(p, js.SamplingParams(max_new_tokens=6))
                for p in prompts]
    ref_eng.run()
    eng = warmed(_engine, ts)
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=6))
            for p in prompts]
    for _ in range(3):
        eng.step()
    snap = eng.snapshot()
    assert snap["pool_host"]["counters"]["cow_forks"] >= 1
    restored = ContinuousBatchingEngine.restore(snap, CFG, params[1],
                                                device="cpu")
    assert _finish(restored, reqs) == [list(r.output_tokens)
                                       for r in ref_reqs]


def test_snapshot_preserves_unreported_completions(params):
    """A request finished by the snapshot's own drain (in overflow,
    unreported) comes back from the restore and surfaces exactly once."""
    eng = _engine(params)
    short = eng.add_request(PROMPTS[2], SamplingParams(max_new_tokens=1))
    long = eng.add_request(PROMPTS[0], SamplingParams(max_new_tokens=8))
    eng.step()
    snap = eng.snapshot()
    assert short.req_id in snap["overflow"]
    restored = ContinuousBatchingEngine.restore(snap, CFG, params[1],
                                                device="cpu")
    fin = {}
    while restored.has_work():
        for r in restored.step():
            assert r.req_id not in fin
            fin[r.req_id] = r
    assert fin[short.req_id].finish_reason is FinishReason.LENGTH
    assert list(fin[short.req_id].output_tokens) == \
        list(short.output_tokens) == _reference_tokens("_greedy")[2][:1]
    assert list(fin[long.req_id].output_tokens) == \
        _reference_tokens("_greedy")[0]


def test_snapshot_is_a_copy_of_the_engines_state(params):
    """The engine steps on after a snapshot and the snapshot stays as it
    was (on the CPU ``.cpu()`` would hand back the live buffers
    themselves); restored later, it continues to the reference's tokens."""
    eng = _engine(params)
    reqs = _add_all(eng, ts, "_sampled")
    for _ in range(3):
        eng.step()
    snap = eng.snapshot()
    frozen = tree_map(torch.clone, snap["device"])
    for _ in range(3):
        eng.step()
    now, then = [], []
    tree_map(now.append, snap["device"])
    tree_map(then.append, frozen)
    assert all(torch.equal(a, b) for a, b in zip(now, then))
    restored = ContinuousBatchingEngine.restore(snap, CFG, params[1],
                                                device="cpu")
    assert _finish(restored, reqs) == _reference_tokens("_sampled")


def test_restore_validates_model_and_geometry(params):
    eng = _engine(params)
    eng.add_request(PROMPTS[0], SamplingParams(max_new_tokens=4))
    snap = eng.snapshot()
    wrong = dataclasses.replace(CFG, name="other")
    with pytest.raises(ValueError, match="model"):
        restore_engine(snap, wrong, params[1], device="cpu")
    with pytest.raises(ValueError, match="fixed by the snapshot"):
        restore_engine(snap, CFG, params[1], device="cpu", max_slots=2)
    # an engine of other geometry, or one with work, refuses it in place
    with pytest.raises(ValueError, match="fixed by the snapshot"):
        restore_into(_engine(params, max_slots=2), snap)
    busy = _engine(params)
    busy.add_request(PROMPTS[1], SamplingParams(max_new_tokens=2))
    with pytest.raises(ValueError, match="idle"):
        restore_into(busy, snap)


def test_reserve_req_ids_prevents_collisions(params):
    eng = _engine(params)
    req = eng.add_request(PROMPTS[0], SamplingParams(max_new_tokens=4))
    restored = ContinuousBatchingEngine.restore(eng.snapshot(), CFG,
                                                params[1], device="cpu")
    fresh = restored.add_request(PROMPTS[1], SamplingParams(max_new_tokens=2))
    assert fresh.req_id > req.req_id
    reserve_req_ids(10_000)
    another = restored.add_request(PROMPTS[2],
                                   SamplingParams(max_new_tokens=2))
    assert another.req_id > 10_000


# ---------------------------------------------------------------------------
# on-disk round trip
# ---------------------------------------------------------------------------


def test_save_restore_latest_roundtrip(params, tmp_path):
    eng = _engine(params)
    reqs = _add_all(eng, ts, "_greedy")
    eng.step()
    eng.step()
    eng.save_snapshot(tmp_path)
    eng.step()
    eng.step()
    eng.save_snapshot(tmp_path)   # the newer snapshot wins
    restored = ContinuousBatchingEngine.restore_latest(tmp_path, CFG,
                                                       params[1],
                                                       device="cpu")
    assert restored.step_idx == 4
    assert _finish(restored, reqs) == _reference_tokens("_greedy")


def test_on_disk_corruption_detected(params, tmp_path):
    eng = _engine(params)
    eng.add_request(PROMPTS[0], SamplingParams(max_new_tokens=4))
    eng.step()
    eng.save_snapshot(tmp_path)
    victim = next(p for p in (tmp_path / "step_00000001").glob("kv__*.npy"))
    raw = bytearray(victim.read_bytes())
    raw[-8] ^= 0xFF
    victim.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="crc"):
        load_snapshot(tmp_path, CFG)


def test_host_only_snapshot_on_disk(params, tmp_path):
    eng = _engine(params)
    reqs = _add_all(eng, ts, "_greedy")
    eng.step()
    save_snapshot(tmp_path, eng.snapshot(include_kv=False))
    snap = load_snapshot(tmp_path, CFG)
    assert "device" not in snap
    restored = restore_engine(snap, CFG, params[1], device="cpu")
    assert _finish(restored, reqs) == _reference_tokens("_greedy")


# ---------------------------------------------------------------------------
# supervisor: missed heartbeat -> restart-recoverable
# ---------------------------------------------------------------------------


def test_supervisor_detects_and_recovers(params):
    sup = EngineSupervisor(timeout_s=10.0)
    eng = _engine(params)
    sup.attach(eng)
    reqs = _add_all(eng, ts, "_greedy")
    eng.step()
    eng.step()
    sup.publish(eng.snapshot())
    last_beat = sup.heartbeat._last[sup.rank]
    assert not sup.engine_failed(now=last_beat + 5.0)
    assert sup.engine_failed(now=last_beat + 11.0)
    recovered = sup.recover(CFG, params[1], device="cpu")
    recovered.step()
    assert not sup.engine_failed(now=sup.heartbeat._last[sup.rank])
    assert _finish(recovered, reqs) == _reference_tokens("_greedy")
    assert_recovery_invariants(recovered)


def test_supervisor_without_snapshot_raises(params):
    sup = EngineSupervisor()
    with pytest.raises(RuntimeError, match="no snapshot"):
        sup.recover(CFG, params[1], device="cpu")


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

CROSS = {
    # (sampling, kv_dtype)
    "greedy": ("_greedy", None),
    "sampled": ("_sampled", None),
    "int8_kv": ("_greedy", "int8"),
    "bf16_pool": ("_greedy", "bf16"),
}


@pytest.mark.parametrize("case", sorted(CROSS))
def test_reference_snapshot_restored_by_port(params, tmp_path, case):
    """The reference saves mid-decode; the port reads every leaf (a bf16
    pool's ``'<V2'`` words as torch.bfloat16, the uint32 keys as int32
    bits) and continues with the reference's uninterrupted tokens."""
    sampling, kv_dtype = CROSS[case]
    jeng = _jengine(params, kv_dtype=kv_dtype)
    reqs = _add_all(jeng, js, sampling)
    for _ in range(3):
        jeng.step()
    jeng.save_snapshot(tmp_path)
    manifest = json.loads((tmp_path / "step_00000003" /
                           "manifest.json").read_text())
    assert manifest["leaves"]["keys"]["dtype"] == "uint32"
    if kv_dtype == "bf16":
        assert manifest["leaves"]["kv__layers__attn__k_pages"]["dtype"] \
            == "bfloat16"
    restored = ContinuousBatchingEngine.restore_latest(
        tmp_path, CFG, params[1], device="cpu")
    if kv_dtype == "bf16":
        assert restored.pool["layers"]["attn"]["k_pages"].dtype \
            == torch.bfloat16
    assert _finish(restored, reqs) == _reference_tokens(sampling, kv_dtype)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_port_snapshot_restored_by_reference(params, tmp_path, kv_dtype):
    eng = _engine(params, kv_dtype=kv_dtype)
    reqs = _add_all(eng, ts, "_sampled")
    for _ in range(3):
        eng.step()
    eng.save_snapshot(tmp_path)
    restored = js.ContinuousBatchingEngine.restore_latest(tmp_path, JCFG,
                                                          params[0])
    assert _finish(restored, reqs) == _reference_tokens("_sampled",
                                                        kv_dtype)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_both_packages_snapshot_alike(params, tmp_path, kv_dtype):
    """The same trace snapshotted at the same step by both packages (their
    request ids aligned first): the same leaf ids, shapes and dtypes, the
    same manifest ``extra``, the same key words, KV within 2e-5."""
    from repro.serving.request import reserve_req_ids as jreserve

    top = max(js.Request(prompt=[1]).req_id, ts.Request(prompt=[1]).req_id)
    jreserve(top)
    reserve_req_ids(top)
    dirs = {"jax": tmp_path / "jax", "torch": tmp_path / "torch"}
    for name, make, pk in (("jax", _jengine, js), ("torch", _engine, ts)):
        eng = make(params, kv_dtype=kv_dtype)
        _add_all(eng, pk, "_sampled")
        for _ in range(4):
            eng.step()
        eng.save_snapshot(dirs[name])
    man = {k: json.loads((d / "step_00000004" / "manifest.json").read_text())
           for k, d in dirs.items()}
    assert man["torch"]["extra"] == man["jax"]["extra"]
    lt, lj = man["torch"]["leaves"], man["jax"]["leaves"]
    assert sorted(lt) == sorted(lj)
    for pid in lj:
        assert (lt[pid]["shape"], lt[pid]["dtype"]) == \
            (lj[pid]["shape"], lj[pid]["dtype"]), pid
        a = np.load(dirs["torch"] / "step_00000004" / f"{pid}.npy")
        b = np.load(dirs["jax"] / "step_00000004" / f"{pid}.npy")
        if pid.startswith("kv__") and a.dtype == np.float32:
            assert np.abs(a - b).max() <= KV_TOL, pid
        elif pid.startswith("kv__"):
            # int8 pages: at most one step, and only at a rare tie (a
            # rounding rule of its own would move far more entries)
            d = a.astype(np.int32) - b
            assert np.abs(d).max() <= 1, pid
            assert np.count_nonzero(d) < 1e-4 * d.size, pid
        else:
            assert np.array_equal(a, b), pid
            assert lt[pid]["crc32"] == lj[pid]["crc32"], pid


def test_interrupted_save_leaves_latest_intact(params, tmp_path,
                                               monkeypatch):
    """A save cut before its rename (the process died mid-write) leaves
    only a ``.tmp`` directory: the latest step is still the previous
    snapshot, and it restores to the reference's tokens."""
    eng = _engine(params)
    reqs = _add_all(eng, ts, "_greedy")
    eng.step()
    eng.save_snapshot(tmp_path)
    eng.step()
    writes = []

    def dying_write(path, arr, descr):
        if writes:
            raise KeyboardInterrupt("killed mid-save")
        writes.append(path)
        np.save(path, arr)

    monkeypatch.setattr(store, "_write_npy", dying_write)
    with pytest.raises(KeyboardInterrupt):
        eng.save_snapshot(tmp_path)
    monkeypatch.undo()
    assert (tmp_path / "step_00000002.tmp").is_dir()
    assert latest_step(tmp_path) == 1
    restored = ContinuousBatchingEngine.restore_latest(tmp_path, CFG,
                                                       params[1],
                                                       device="cpu")
    assert restored.step_idx == 1
    assert _finish(restored, reqs) == _reference_tokens("_greedy")
    # the next save replaces the stale .tmp
    save_checkpoint(tmp_path, 2, {"x": torch.ones(2)})
    assert latest_step(tmp_path) == 2
    assert not (tmp_path / "step_00000002.tmp").exists()


def test_store_writes_bf16_as_the_reference_does(tmp_path):
    """A bf16 leaf's file is the bytes ``np.save`` writes for an ml_dtypes
    bfloat16 array, and it reads back bitwise."""
    import ml_dtypes

    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    save_checkpoint(tmp_path / "port", 1, {"a": {"w": x}})
    ref = x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    jsave_dir = tmp_path / "jax"
    from repro.checkpoint.store import save_checkpoint as jsave

    jsave(jsave_dir, 1, {"a": {"w": ref}})
    mine = (tmp_path / "port" / "step_00000001" / "a__w.npy").read_bytes()
    theirs = (jsave_dir / "step_00000001" / "a__w.npy").read_bytes()
    assert mine == theirs
    for d in (tmp_path / "port", jsave_dir):
        back, man = store.restore_checkpoint(
            d, 1, {"a": {"w": torch.empty(3, 5, dtype=torch.bfloat16,
                                          device="meta")}})
        assert man["leaves"]["a__w"]["dtype"] == "bfloat16"
        assert torch.equal(back["a"]["w"].view(torch.int16),
                           x.view(torch.int16))


def test_keys_leaf_is_the_engines_words_as_uint32(params, tmp_path):
    eng = _engine(params)
    _add_all(eng, ts, "_sampled")
    for _ in range(3):
        eng.step()
    snap = eng.save_snapshot(tmp_path)
    keys = np.load(tmp_path / "step_00000003" / "keys.npy")
    assert keys.dtype == np.uint32
    assert np.array_equal(keys.view(np.int32), eng._keys.numpy())
    assert np.array_equal(keys.view(np.int32), snap["device"]["keys"])
    back = load_snapshot(tmp_path, CFG)
    assert back["device"]["keys"].dtype == torch.int32
    assert torch.equal(back["device"]["keys"], eng._keys)


# ---------------------------------------------------------------------------
# in place: the step graphs' buffers survive a restore
# ---------------------------------------------------------------------------


def _buffers(eng) -> list:
    leaves: list = []
    tree_map(leaves.append, eng.pool)
    return [t.data_ptr() for t in leaves + [eng._tok, eng._keys,
                                            eng._temp]]


def test_restore_into_captured_engine_keeps_its_buffers(params):
    """An engine whose step graphs (a host stand-in for CUDA graphs) were
    captured takes a snapshot in place: every device buffer keeps its
    storage, the graphs replay on the restored state, and the sampled
    streams continue to the reference's tokens."""
    warm = _with_host_graphs(_engine(params))
    for n in (1, 2, 3, 5, 9):
        warm.add_request(list(range(1, n + 1)), SamplingParams(
            max_new_tokens=3, temperature=0.7, seed=n))
    warm.run()
    g = warm.step_graphs
    assert g.captures > 0 and not warm.has_work()
    ptrs, replays = _buffers(warm), g.replays

    eng = _engine(params)
    reqs = _add_all(eng, ts, "_sampled")
    for _ in range(3):
        eng.step()
    restore_into(warm, eng.snapshot())
    assert _buffers(warm) == ptrs
    assert torch.equal(warm._keys, eng._keys)
    assert torch.equal(warm._tok, eng._tok)
    assert _finish(warm, reqs) == _reference_tokens("_sampled")
    assert g.replays > replays
    assert_recovery_invariants(warm)


# ---------------------------------------------------------------------------
# tensor parallelism: tp = 2 <-> tp = 1 through the store
# ---------------------------------------------------------------------------


def test_tp2_and_tp1_snapshots_restore_across_meshes(params, tmp_path):
    """A tp = 1 snapshot restored by two gloo ranks (each loads its KV
    heads), and the ranks' own tp = 2 snapshot (rank 0 writes, the pages
    gathered from both) restored at tp = 1: both continue with the
    reference's uninterrupted tokens."""
    eng = _engine(params)
    reqs = _add_all(eng, ts, "_sampled")
    for _ in range(3):
        eng.step()
    eng.save_snapshot(tmp_path / "tp1")
    np_params = jax.tree_util.tree_map(np.asarray, params[0])
    job = {"cfg": CFG, "params": np_params, "geom": GEOM,
           "tp1_dir": str(tmp_path / "tp1"),
           "tp2_dir": str(tmp_path / "tp2"),
           "prompts": PROMPTS, "sampling": [_sampled(i) for i in
                                            range(len(PROMPTS))],
           "steps": 4}
    ranks = run_ranks(W.snapshot_across_meshes, 2, backend="gloo",
                      device="cpu", args=(job,), timeout_s=240)
    want = _reference_tokens("_sampled")
    for r in ranks:
        assert r["restored_tp1_tokens"] == want
        assert r["kv_shard"] == 2
        assert r["jax_or_reference_loaded"] == []
    assert ranks[0]["restored_tp1_tokens"] == ranks[1]["restored_tp1_tokens"]
    back = ContinuousBatchingEngine.restore_latest(tmp_path / "tp2", CFG,
                                                   params[1], device="cpu")
    assert back.kv.kv_shard == 1 and back.step_idx == 4
    fin = {r.req_id: r for r in back.run()}
    assert [list(fin[i].output_tokens) for i in ranks[0]["tp2_req_ids"]] \
        == want
    assert reqs and Path(tmp_path / "tp2" / "step_00000004").is_dir()
