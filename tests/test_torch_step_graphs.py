"""The engine step as CUDA graphs (``serving.step_graphs``), on the CPU.

* The function each graph captures -- ``_packed_step``: the step on its
  packed int32 buffer, with the chained device token and the slots' PRNG
  keys updated in place -- is bitwise ``_mixed_step`` over span buckets 1
  to 64 and chained steps, float and int8 pools, greedy and drawing.
* ``StepGraphs``' bookkeeping, through a host stand-in for a CUDA graph
  (a capture runs nothing and leaves the state as it was; a replay
  overwrites the outputs the capture returned): the engine serves the
  same tokens, step logits and pool bitwise as the eager engine, over a
  plain, a preempting and a copy-on-write trace; the first step of a
  bucket is eager and the later ones replay; launch counts read the same
  per step as eagerly.  A bucket is (span bucket, any row drawing): a
  trace mixing greedy and sampled requests captures both kinds and serves
  what the eager engine serves.
* The span kernel's workspace, reserved once for every bucket
  (``kernels.paged.reserve_workspace``), covers each bucket's geometry,
  and each captured graph holds the workspace it launches on, after a
  larger launch has replaced it too.
* Graphs need a card: without one, asking for them raises."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree_map
from repro_torch.configs import get_config
from repro_torch.kernels import _build, paged
from repro_torch.models import transformer as T
from repro_torch.serving import ContinuousBatchingEngine, SamplingParams
from repro_torch.serving.engine import _mixed_step, _packed_step
from repro_torch.serving.step_graphs import StepGraphs


def _cfg():
    cfg = get_config("gpt2-medium").reduced()
    return dataclasses.replace(
        cfg, dtype="float32", paged_kernel=True,
        monarch=dataclasses.replace(cfg.monarch, backend="pallas"))


@pytest.fixture(scope="module")
def model():
    cfg = _cfg()
    return cfg, T.init_params(cfg, seed=0, device="cpu")


def _leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _same_pools(a, b) -> bool:
    """Every page but the sink (page 0: padding rows land there, and an
    index_put resolves their duplicates in no fixed order) and every
    scale, bitwise."""
    return all(torch.equal(x[:, 1:], y[:, 1:]) if x.dim() == 5
               else torch.equal(x, y)
               for x, y in zip(_leaves(a), _leaves(b)))


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_packed_step_is_mixed_step_bitwise(model, kv_dtype):
    """Three chained steps at each bucket: a prefill row, a decode row fed
    the previous step's device token, an inert row and a shorter span."""
    _packed_vs_mixed(model, kv_dtype, draw=False)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_packed_step_is_mixed_step_bitwise_when_drawing(model, kv_dtype):
    """The same steps with the decode row sampling at temperature 0.8."""
    _packed_vs_mixed(model, kv_dtype, draw=True)


def _packed_vs_mixed(model, kv_dtype, draw: bool) -> None:
    cfg, params = model
    B, pg, MP = 4, 16, 16
    pool_a = T.init_paged_pool(cfg, 1 + B * MP, pg, kv_dtype=kv_dtype,
                               device="cpu")
    pool_b = tree_map(torch.clone, pool_a)
    tok_a = torch.zeros(B, dtype=torch.int32)
    tok_b = tok_a.clone()
    keys_a = torch.tensor([[0, 1], [0, 7], [5, -3], [0, 9]],
                          dtype=torch.int32)
    keys_b = keys_a.clone()
    temps = torch.tensor([0.0, 0.8 if draw else 0.0, 0.0, 0.0])
    pt = (1 + np.arange(B * MP, dtype=np.int32)).reshape(B, MP)
    rng = np.random.default_rng(0)
    starts = np.array([0, 100, 0, 37], np.int32)
    for S in (1, 2, 4, 8, 16, 32, 64):
        for _ in range(3):
            span = np.array([S, 1, 0, max(1, S // 2)], np.int32)
            chunk = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
            use_dev = np.array([0, 1, 0, 0], np.int32)
            sample = np.array([1, 1, 0, 1], np.int32)
            wstart = np.zeros(B, np.int32)
            packed = np.concatenate([chunk.reshape(-1), starts, span, use_dev,
                                     sample, wstart, pt.reshape(-1)])
            sampled_a, logits_a = _packed_step(
                params, pool_a, cfg, tok_a, keys_a, temps,
                torch.from_numpy(packed), (S, draw))
            t = torch.from_numpy
            sampled_b, tok_b, logits_b = _mixed_step(
                params, pool_b, cfg, t(chunk), tok_b, t(use_dev).bool(),
                t(starts), t(span), t(pt), t(wstart), t(sample).bool(),
                temps, keys_b, draw)
            assert torch.equal(sampled_a, sampled_b)
            assert torch.equal(logits_a, logits_b)
            assert torch.equal(tok_a, tok_b)
            assert torch.equal(keys_a, keys_b)
            starts = (starts + span) % (MP * pg - 64)
    assert _same_pools(pool_a, pool_b)


class _HostGraph:
    """A CPU stand-in for a CUDA graph: ``capture`` runs the step once for
    its outputs and puts the state it wrote back (a capture runs
    nothing); ``replay`` runs it again, counting no launch on the host,
    and writes the outputs into the tensors the capture returned (a
    graph's outputs are static)."""

    def __init__(self, state):
        self._state = state   # the tensors a step writes

    def capture(self, fn):
        saved = [t.clone() for t in self._state()]
        self._fn, self._out = fn, fn()
        for t, s in zip(self._state(), saved):
            t.copy_(s)
        return self._out

    def replay(self):
        counted = dict(_build.LAUNCHES)   # a replay runs no Python
        for out, new in zip(self._out, self._fn()):
            out.copy_(new)
        _build.LAUNCHES.update(counted)


def _with_host_graphs(eng):
    eng.step_graphs = StepGraphs(
        eng._step, new_graph=lambda: _HostGraph(
            lambda: _leaves(eng.pool) + [eng._tok, eng._keys]))
    return eng


TRACES = {
    "plain": (dict(max_slots=4, max_len=96, chunk_size=16),
              [5, 17, 33, 40], 0),
    "preemption": (dict(max_slots=4, max_len=96, chunk_size=8, n_pages=9),
                   [5, 17, 33, 40], 0),
    "prefix_cow": (dict(max_slots=4, max_len=96, chunk_size=16), None, 3),
}


def _serve(cfg, params, kw, prompts, stagger, graphs: bool):
    eng = ContinuousBatchingEngine(cfg, params, page_size=8, device="cpu",
                                   use_paged_kernel=True, **kw)
    if graphs:
        _with_host_graphs(eng)
    logits, reqs, pending, steps = [], [], list(prompts), 0
    while pending or eng.has_work():
        if pending and (stagger == 0 or steps % stagger == 0):
            while pending:
                reqs.append(eng.add_request(
                    pending.pop(0), SamplingParams(max_new_tokens=6)))
                if stagger:
                    break
        before = eng.stats["mixed_steps"]
        eng.step()
        if eng.stats["mixed_steps"] > before:
            logits.append(eng.step_logits[torch.from_numpy(eng.step_rows)]
                          .clone())
        steps += 1
        assert steps < 300
    return eng, [r.output_tokens for r in reqs], logits


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("trace", sorted(TRACES))
def test_engine_through_step_graphs_matches_the_eager_engine(model, kv_dtype,
                                                             trace):
    cfg, params = model
    kw, lengths, stagger = TRACES[trace]
    rng = np.random.default_rng(1)
    if lengths is None:   # a shared 20-token prefix, forked copy-on-write
        prefix = list(rng.integers(0, cfg.vocab, 20))
        prompts = [prefix + [7 * i + j for j in range(2 + i % 2)]
                   for i in range(3)]
        prompts += [prompts[1], prompts[0] + [5, 6]]
    else:
        prompts = [list(rng.integers(0, cfg.vocab, n)) for n in lengths]
    kw = dict(kw, kv_dtype=kv_dtype)
    eager, toks_e, lg_e = _serve(cfg, params, kw, prompts, stagger, False)
    graphed, toks_g, lg_g = _serve(cfg, params, kw, prompts, stagger, True)
    assert eager.step_graphs is None
    assert toks_g == toks_e
    assert len(lg_g) == len(lg_e)
    assert all(torch.equal(a, b) for a, b in zip(lg_g, lg_e))
    assert _same_pools(graphed.pool, eager.pool)
    g = graphed.step_graphs
    assert g.captures == len(g.buckets) and g.replays > 0
    assert g.captures + g.replays == graphed.stats["mixed_steps"]
    if trace == "preemption":
        assert graphed.stats["preemptions"] > 0
    if trace == "prefix_cow":
        assert graphed.stats["cow_forks"] > 0


def test_launch_counts_read_as_eager_under_replay():
    """A step that launches 3 kernels: its first (eager) run counts 3, the
    capture nets 0, every replay adds 3."""
    calls = []

    def step(buf, S):
        calls.append(S)
        _build.LAUNCHES["monarch_fused"] += 3
        return buf * 2, buf + 1

    def upload(host, out=None):
        t = torch.from_numpy(host.copy())
        return t if out is None else out.copy_(t)

    state = torch.zeros(1)
    g = StepGraphs(step, new_graph=lambda: _HostGraph(lambda: [state]))
    _build.reset_launches()
    for i in range(4):
        before = _build.LAUNCHES["monarch_fused"]
        sampled, logits = g.run(8, np.full(2, i, np.int32), upload)
        assert _build.LAUNCHES["monarch_fused"] - before == 3
        assert torch.equal(sampled, torch.full((2,), 2 * i, dtype=torch.int32))
        assert torch.equal(logits, torch.full((2,), i + 1, dtype=torch.int32))
    # the sampled tokens are the caller's: the next replay leaves them
    kept, _ = g.run(8, np.full(2, 5, np.int32), upload)
    g.run(8, np.full(2, 9, np.int32), upload)
    assert torch.equal(kept, torch.full((2,), 10, dtype=torch.int32))
    assert (g.captures, g.replays, g.buckets) == (1, 5, [8])
    _build.reset_launches()


@pytest.mark.parametrize("B,H,hd,pg,MP", [(8, 16, 64, 16, 64),
                                          (4, 48, 128, 16, 256),
                                          (2, 4, 32, 8, 12)])
def test_workspace_reserved_once_covers_every_bucket(B, H, hd, pg, MP):
    buckets = [1 << i for i in range(7)]
    floats, tickets = paged.span_workspace_size(B, H, hd, pg, MP, buckets)
    for S in buckets:
        g = paged.span_geometry(S, hd, pg, MP)
        if g.n_splits > 1:
            assert floats >= B * H * g.workspace_floats
            assert tickets >= B * H * g.n_tiles
    cpu = torch.device("cpu")
    paged._WORKSPACE.pop(-1, None)
    assert paged.reserve_workspace(cpu, B, H, hd, pg, MP, buckets) == (
        floats, tickets)
    if floats:
        ws, tk = paged._WORKSPACE[-1]
        assert ws.numel() == floats and tk.numel() == tickets
        # every bucket's launch then finds the same buffers
        for S in buckets:
            g = paged.span_geometry(S, hd, pg, MP)
            got = paged._workspace(cpu, B * H * g.workspace_floats,
                                   B * H * g.n_tiles)
            assert got[0] is ws and got[1] is tk
        # a graph captured now keeps them; a larger launch then replaces
        # them, and the graph still holds the ones it launches on
        g = StepGraphs(lambda buf, S: (buf + 1, buf * 2),
                       new_graph=lambda: _HostGraph(lambda: []))
        g.run(1, np.zeros(2, np.int32),
              lambda p, out=None: torch.from_numpy(p.copy()))
        assert any(t is ws for t in g._buckets[1].keep)
        assert any(t is tk for t in g._buckets[1].keep)
        paged._workspace(cpu, floats + 1, tickets + 1)
        assert paged._WORKSPACE[-1][0] is not ws
        assert paged._WORKSPACE[-1][1] is not tk
        assert [id(t) for t in paged.workspaces()] == [
            id(t) for pair in paged._WORKSPACE.values() for t in pair]
        assert any(t is ws for t in g._buckets[1].keep)
    paged._WORKSPACE.pop(-1, None)


def test_graphs_need_a_card(model, monkeypatch):
    cfg, params = model
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            StepGraphs(lambda buf, S: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(cfg, params, max_len=32, page_size=8,
                                 device="cuda")
    eng = ContinuousBatchingEngine(cfg, params, max_len=32, page_size=8,
                                   device="cpu")
    assert eng.step_graphs is None


def test_greedy_and_drawing_batches_replay_their_own_graphs(model):
    """Greedy and sampled requests in one trace: a batch whose sampling
    rows are all greedy replays a graph without the draw, one with a row
    at temperature > 0 a graph with it, at the same span bucket; tokens,
    step logits and keys are the eager engine's."""
    cfg, params = model
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(0, cfg.vocab, n)) for n in (5, 17, 9, 30)]
    out = {}
    for graphs in (False, True):
        eng = ContinuousBatchingEngine(cfg, params, page_size=8,
                                       device="cpu", use_paged_kernel=True,
                                       max_slots=4, max_len=96,
                                       chunk_size=16)
        if graphs:
            _with_host_graphs(eng)
        reqs, logits, steps = [], [], 0
        while prompts[len(reqs):] or eng.has_work():
            if len(reqs) < len(prompts) and steps % 4 == 0:
                i = len(reqs)
                reqs.append(eng.add_request(prompts[i], SamplingParams(
                    max_new_tokens=6, temperature=0.8 * (i % 2), seed=i)))
            before = eng.stats["mixed_steps"]
            eng.step()
            if eng.stats["mixed_steps"] > before:
                logits.append(eng.step_logits[torch.from_numpy(
                    eng.step_rows)].clone())
            steps += 1
            assert steps < 300
        out[graphs] = ([r.output_tokens for r in reqs], logits,
                       eng._keys.clone(), eng)
    toks_e, lg_e, keys_e, _ = out[False]
    toks_g, lg_g, keys_g, graphed = out[True]
    assert toks_g == toks_e
    assert all(torch.equal(a, b) for a, b in zip(lg_g, lg_e))
    assert torch.equal(keys_g, keys_e)
    g = graphed.step_graphs
    kinds = {S: {d for s, d in g.buckets if s == S} for S, _ in g.buckets}
    assert {True, False} in kinds.values()
    assert g.captures == len(g.buckets) and g.replays > 0
