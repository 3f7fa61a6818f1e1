"""The single-pod dry run (``launch/{mesh,hlo_analysis,dryrun}.py``)
against the JAX reference and against the port's own steps, on the CPU.

* ``make_production_mesh``: data 16 x model 16, world rank ``r`` at
  ``(r // 16, r % 16)``, shape-only groups on ``meta``; the multi-pod
  mesh raises; a shape-only group refuses a tensor that is not ``meta``
  and returns the real call's shape, recording each collective; a train
  step refuses a shape-only mesh whose device is not ``meta``;
* ``RooflineTerms.as_dict()`` equals the reference's on the same inputs
  (zero denominators included) once the port's rates are set to the
  reference's; the rates are the H100's, and ``chip_smoke.py`` takes
  them from here;
* all 12 x 4 cells: the reference's skip reasons and its model-FLOPs
  formula on its own ``active_param_count()``;
* at ``.reduced()`` widths: a prefill step's traced FLOPs equal the sum
  of its products counted by hand; ``count_step`` on ``meta`` equals
  ``count_step`` on CPU tensors (prefill, decode, train); a serving
  step at L and at L - 1 layers (a hybrid: one group fewer) differs by
  exactly its bodies (FLOPs, bytes, collectives), a train step by its
  bodies' FLOPs and collectives; a train cell's argument bytes equal the
  bytes of a rank's real shards, moments and rows;
* every config's shards are the same shape on every rank of (16, 16);
* ``--scheme a2a``, ``--multi-pod`` and ``--all`` without
  ``--single-pod-only`` raise; a meta tensor reaching B1-B6, X2 or X3
  raises and launches nothing.

The dry run's collectives against a real gloo world are checked in
``tests/test_torch_train_mesh.py``'s world.  The reference's
``repro.launch.dryrun`` is never imported here: it sets XLA_FLAGS for 512
host devices at import.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import shapes as JSH
from repro.launch import hlo_analysis as JH
from repro_torch import tree_map
from repro_torch.configs import PORTED_ARCHS
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import shapes as TSH
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import (Mesh, make_production_mesh, run_ranks,
                                     shape_mesh)
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.sharding import api
from repro_torch.sharding import params as SP

ROOT = Path(__file__).resolve().parents[1]
SHAPE_NAMES = list(JSH.SHAPES)
# small cells in the production cells' place (the steps read SHAPES)
SMALL = {"train_4k": TSH.ShapeCell("train_4k", 16, 16, "train"),
         "prefill_32k": TSH.ShapeCell("prefill_32k", 16, 4, "prefill"),
         "decode_32k": TSH.ShapeCell("decode_32k", 32, 4, "decode")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small(monkeypatch):
    for name, cell in SMALL.items():
        monkeypatch.setitem(TSH.SHAPES, name, cell)


def _bf16(cfg):
    return dataclasses.replace(cfg, dtype="bfloat16")


# -- (a) the mesh ------------------------------------------------------------

@pytest.mark.parametrize("rank,at", [(0, (0, 0)), (17, (1, 1)),
                                     (255, (15, 15))])
def test_production_mesh_places_ranks(rank, at):
    mesh = make_production_mesh(rank=rank)
    assert (mesh.data, mesh.model, mesh.world) == (16, 16, 256)
    assert (mesh.data_rank, mesh.model_rank) == at
    assert mesh.device == torch.device("meta") and mesh.backend == "nccl"
    assert mesh.group == api.ShapeGroup("model", 16, at[1], "nccl")
    assert mesh.data_group == api.ShapeGroup("data", 16, at[0], "nccl")
    assert mesh.host_group is None


def test_multi_pod_mesh_raises():
    with pytest.raises(NotImplementedError, match="pod"):
        make_production_mesh(multi_pod=True)


COLLECTIVES = {
    "reduce": lambda x, g: api._reduce(x, g),
    "stats": lambda x, g: api.reduce_stats(x, g, "max"),
    "gather": lambda x, g: api._gather(x, g, 0),
    "slice": lambda x, g: api._slice(x, g, 0),
    "reduce_scatter": lambda x, g: api._reduce_scatter(x, g, 0),
}


@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_shape_only_group_refuses_a_real_tensor(name):
    g = shape_mesh(2, 4, backend="gloo").group
    with pytest.raises(RuntimeError, match="meta"):
        COLLECTIVES[name](torch.ones(8, 3), g)


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_shape_only_collectives_return_the_real_shapes(backend):
    mesh = shape_mesh(2, 4, rank=6, backend=backend)
    x = torch.empty((8, 3), dtype=torch.bfloat16, device="meta")
    api.reset_collective_bytes()
    api.reset_collectives()
    shapes = {n: tuple(f(x, mesh.group).shape)
              for n, f in COLLECTIVES.items()}
    assert shapes == {"reduce": (8, 3), "stats": (8, 3), "gather": (32, 3),
                      "slice": (2, 3), "reduce_scatter": (2, 3)}
    assert COLLECTIVES["reduce"](x, mesh.group).dtype == torch.bfloat16
    fp32 = 8 * 3 * 4
    want = {("all-reduce", "model", fp32): 3, ("all-gather", "model", 48): 1}
    if backend == "gloo":    # gloo: all-reduce the whole, then slice
        want[("all-reduce", "model", fp32)] += 1
        counts = {"all_reduce": 4, "all_gather": 1}
    else:
        want[("reduce-scatter", "model", fp32)] = 1
        counts = {"all_reduce": 3, "all_gather": 1, "reduce_scatter": 1}
    assert api.collective_bytes() == want
    assert api.collectives() == counts
    assert H.collective_bytes(want) == {
        k: sum(b * n for (kk, _, b), n in want.items() if kk == k)
        for k in {k for k, _, _ in want}}


def test_train_step_refuses_a_shape_only_mesh_off_meta():
    cfg = tget_config("gpt2-medium").reduced()
    mesh = dataclasses.replace(shape_mesh(2, 2, backend="gloo"),
                               device=torch.device("cpu"))
    with pytest.raises(ValueError, match="meta"):
        S.make_train_step(cfg, mesh=mesh)
    S.make_train_step(cfg, mesh=shape_mesh(2, 2))      # on meta it traces


# -- (b) the roofline terms --------------------------------------------------

TERMS = [(0.0, 0.0, 0.0, 256, 0.0), (0.0, 0.0, 0.0, 256, 1e15),
         (3.1e14, 2.0e11, 1.0e9, 256, 4.4e17),     # compute
         (1.0e12, 9.0e11, 1.0e9, 256, 2.0e15),     # memory
         (1.0e12, 1.0e9, 6.0e10, 256, 2.0e15),     # collective
         (5e12, 5e12, 5e12, 1, 5e12)]


@pytest.mark.parametrize("terms", TERMS)
def test_roofline_terms_equal_the_reference(monkeypatch, terms):
    monkeypatch.setattr(H, "PEAK_FLOPS", JH.PEAK_FLOPS)
    monkeypatch.setattr(H, "HBM_BW", JH.HBM_BW)
    monkeypatch.setattr(H, "NET_BW", JH.ICI_BW)
    assert H.RooflineTerms(*terms).as_dict() == \
        JH.RooflineTerms(*terms).as_dict()


def test_rates_are_the_h100s_and_chip_smoke_shares_them():
    assert (H.PEAK_FLOPS, H.HBM_BW, H.NET_BW) == (989e12, 3.35e12, 50e9)
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.HBM_BYTES_PER_S is H.HBM_BW
    assert chip_smoke.BF16_FLOPS_PER_S is H.PEAK_FLOPS


# -- (c) skips and model FLOPs -----------------------------------------------

def test_the_port_has_the_references_cells():
    """The port's --all runs the reference's ALL_ARCHS and its two paper
    models (names compare after '.' -> '_')."""
    from repro.configs import ALL_ARCHS, PAPER_MODELS_JAX
    assert sorted(a.replace(".", "_") for a in PORTED_ARCHS) == \
        sorted(a.replace(".", "_") for a in ALL_ARCHS + PAPER_MODELS_JAX)
    assert list(TSH.SHAPES) == SHAPE_NAMES


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_skips_and_model_flops_match_the_reference(arch, shape):
    jc, tc = jget_config(arch), tget_config(arch)
    ok, reason = JSH.cell_supported(jc, shape)
    assert TSH.cell_supported(tc, shape) == (ok, reason)
    if not ok:
        rec = D.run_cell(arch, shape)
        assert (rec["status"], rec["reason"]) == ("skipped", reason)
    cell = JSH.SHAPES[shape]
    n = jc.active_param_count() - (0 if jc.tie_embeddings
                                   else jc.vocab * jc.d_model)
    tokens = cell.global_batch * (1 if cell.step == "decode"
                                  else cell.seq_len)
    want = {"train": 6, "prefill": 2, "decode": 2}[cell.step] * n * tokens
    assert D.model_flops(tc, shape) == float(want)


# -- (d) FLOP counts, meta against real tensors ------------------------------

def _products(p) -> int:
    """Product FLOPs a token of one projection: each Monarch stage's
    einsum (k x q x p, then q x s x k), or a dense (din x dout)."""
    if "L" in p:
        k, q, pp = p["L"].shape[-3:]
        s = p["R"].shape[-2]
        return 2 * (k * q * pp + q * s * k)
    din, dout = p["w"].shape[-2:]
    return 2 * din * dout


def test_prefill_flops_are_the_sum_of_its_products(small):
    cfg = tget_config("gpt2-medium").reduced()
    B, S_ = SMALL["prefill_32k"].global_batch, SMALL["prefill_32k"].seq_len
    layers = T.param_shapes(cfg)["decoder"]["layers"]
    per_token = sum(_products(layers[part][name])
                    for part in ("attn", "ffn") for name in layers[part])
    attn = 2 * 2 * B * cfg.n_heads * S_ * S_ * cfg.hd    # scores, then PV
    head = 2 * B * S_ * cfg.d_model * cfg.vocab_padded
    want = cfg.n_layers * (B * S_ * per_token + attn) + head
    count, _ = D.count_cell(cfg, "prefill_32k", shape_mesh(1, 1))
    assert count.flops == want


def _real(tree):
    g = torch.Generator().manual_seed(0)
    return tree_map(lambda t: torch.randn(t.shape, generator=g).to(t.dtype)
                    if t.is_floating_point() else torch.zeros_like(
                        t, device="cpu"), tree)


def _fields(c):
    return (c.flops, c.bytes, c.ops, c.peak_bytes, c.argument_bytes)


@pytest.mark.parametrize("kind", ["prefill_32k", "decode_32k"])
def test_count_step_on_meta_equals_the_cpu(small, kind):
    cfg = _bf16(tget_config("gpt2-medium").reduced())
    plan, args = D._arguments(cfg, kind, shape_mesh(1, 1))
    fn = D._step_fn(cfg, TSH.SHAPES[kind].step, None, plan, 1)
    meta = H.count_step(fn, *args)
    cpu_args = tuple(_real(a) if isinstance(a, dict) else
                     torch.zeros(a.shape, dtype=a.dtype) for a in args)
    assert _fields(H.count_step(fn, *cpu_args)) == _fields(meta)


@pytest.mark.parametrize("arch", ["gpt2-medium", "mamba2-2.7b"])
def test_train_count_on_meta_equals_the_cpu(arch):
    cfg = _bf16(tget_config(arch).reduced())
    rng = np.random.default_rng(0)
    t = rng.integers(0, cfg.vocab, (4, 17)).astype(np.int32)
    # arrays of their own: a tensor over a numpy view holds its base
    batch = {"tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy()}
    meta = D.count_train_step(cfg, None, batch, adamw(lr=1e-3))
    init, step = S.make_train_step(cfg, adamw(lr=1e-3))
    state = init(0, device="cpu")
    cpu = H.count_step(step, state, S.batch_to(batch, "cpu"))
    assert _fields(cpu) == _fields(meta)
    assert meta.flops > 0 and meta.collectives == {}


# -- (e) bodies --------------------------------------------------------------

def _counts(c):
    return c.flops, c.bytes, H.collective_bytes(c.collectives)


def _bodies(cfg, shape, mesh):
    kind = TSH.SHAPES[shape].step
    return {name: H.count_step(fn, *args)
            for name, _, fn, args in D._body_defs(cfg, shape, mesh, kind)}


def _minus(a, b):
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) - v
    return {k: v for k, v in out.items() if v}


def _pair(arch):
    cfg = _bf16(tget_config(arch).reduced())
    if cfg.layer_kind == "hybrid":     # one group fewer, the same tail
        g = cfg.shared_attn_every
        return (dataclasses.replace(cfg, n_layers=2 * g + 1),
                dataclasses.replace(cfg, n_layers=g + 1))
    return (dataclasses.replace(cfg, n_layers=3),
            dataclasses.replace(cfg, n_layers=2))


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["gpt2-medium", "mamba2-2.7b",
                                  "zamba2-7b"])
def test_a_layer_fewer_costs_its_bodies(small, arch, shape):
    big, less = _pair(arch)
    mesh = shape_mesh(2, 2)
    full = D.count_cell(big, shape, mesh)[0]
    fewer = D.count_cell(less, shape, mesh)[0]
    bodies = _bodies(big, shape, mesh)
    if big.layer_kind == "hybrid":
        g = big.shared_attn_every
        m, a = _counts(bodies["mamba_layer"]), _counts(bodies["shared_attn"])
        want = (g * m[0] + a[0], g * m[1] + a[1],
                {k: g * m[2].get(k, 0) + a[2].get(k, 0)
                 for k in set(m[2]) | set(a[2])})
    else:
        (body,) = bodies.values()
        want = _counts(body)
    got = (full.flops - fewer.flops, full.bytes - fewer.bytes,
           _minus(H.collective_bytes(full.collectives),
                  H.collective_bytes(fewer.collectives)))
    assert got == want
    assert want[0] > 0 and want[2]          # the TP layer's collectives


@pytest.mark.parametrize("arch", ["gpt2-medium", "mamba2-2.7b"])
def test_a_train_layer_fewer_costs_its_bodies_products(small, arch):
    big, less = _pair(arch)
    mesh = shape_mesh(1, 2)
    full = D.count_cell(big, "train_4k", mesh)[0]
    fewer = D.count_cell(less, "train_4k", mesh)[0]
    (body,) = _bodies(big, "train_4k", mesh).values()
    assert full.flops - fewer.flops == body.flops
    assert _minus(H.collective_bytes(full.collectives),
                  H.collective_bytes(fewer.collectives)) == \
        H.collective_bytes(body.collectives)


# -- (g) argument bytes ------------------------------------------------------

def _nbytes(tree) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


@pytest.mark.parametrize("rank", range(4))
def test_train_argument_bytes_are_a_ranks_real_shards(small, rank):
    cfg = tget_config("granite-moe-1b-a400m").reduced()
    # routing groups of 16 tokens: a data rank holds whole groups
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           group_size=16))
    count, alias = D.count_cell(cfg, "train_4k", shape_mesh(2, 2, rank=rank))
    whole = T.init_params(cfg, seed=0, device="cpu")
    mesh = Mesh(model=2, rank=rank, data=2, device="cpu")
    plan, table = S.train_plan(cfg, mesh)
    shards = SP.shard_train_params(whole, plan, table)
    state = {"params": shards, "opt": adamw(lr=1e-3).init(shards)}
    cell = SMALL["train_4k"]
    tokens = np.zeros((cell.global_batch, cell.seq_len), np.int32)
    rows = S.batch_to(S.shard_batch({"tokens": tokens, "labels": tokens},
                                    mesh), "cpu")
    assert count.argument_bytes == _nbytes(state) + _nbytes(rows)
    assert alias == _nbytes(state)


def test_a_cells_record(small, monkeypatch, tmp_path):
    monkeypatch.setattr(D, "get_config",
                        lambda name: tget_config(name).reduced())
    out = tmp_path / "cell.json"
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "gpt2-medium",
                                      "--shape", "train_4k", "--out",
                                      str(out)])
    D.main()
    rec = json.loads(out.read_text())
    assert (rec["status"], rec["n_chips"], rec["rank"], rec["symmetric"]) \
        == ("ok", 256, 0, True)
    mem = rec["memory"]
    assert mem["temp_size_in_bytes"] == (mem["peak_size_in_bytes"]
                                         - mem["argument_size_in_bytes"])
    assert mem["alias_size_in_bytes"] < mem["argument_size_in_bytes"]
    r = rec["roofline"]
    assert r == H.RooflineTerms(
        rec["flops_full"], rec["bytes_full"], sum(rec["coll_full"].values()),
        256, r["model_flops"]).as_dict()
    assert [b["name"] for b in rec["bodies"]] == ["attn_layer"]
    assert rec["bodies"][0]["trips"] == 2
    assert set(rec["coll_full"]) == {"all-gather", "all-reduce",
                                     "reduce-scatter"}


# -- (h) rank symmetry -------------------------------------------------------

@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_every_rank_holds_rank_0s_shapes(arch, shape):
    assert D.rank_symmetry(tget_config(arch), shape) == (True, 0)


def test_an_uneven_rank_is_the_one_traced(monkeypatch):
    cfg = tget_config("gpt2-medium").reduced()
    cut = SP.keep_parts

    def uneven(tree, prefix, table, plan):
        out = cut(tree, prefix, table, plan)
        if plan.mesh.rank == 3 and not prefix:
            out["extra"] = torch.empty(7, device="meta")
        return out

    monkeypatch.setattr(SP, "keep_parts", uneven)
    assert D.rank_symmetry(cfg, "train_4k", mesh_shape=(2, 2)) == (False, 3)


# -- (i) loud failures -------------------------------------------------------

def test_unported_options_raise(monkeypatch):
    with pytest.raises(NotImplementedError, match="a2a"):
        D.run_cell("gpt2-medium", "train_4k", scheme="a2a")
    with pytest.raises(NotImplementedError, match="pod"):
        D.run_cell("gpt2-medium", "train_4k", multi_pod=True)
    for argv in (["--arch", "gpt2-medium", "--shape", "train_4k",
                  "--multi-pod"], ["--all", "--multi-pod-only"], ["--all"],
                 ["--arch", "gpt2-medium", "--shape", "train_4k",
                  "--scheme", "a2a"]):
        monkeypatch.setattr(sys, "argv", ["dryrun", *argv])
        with pytest.raises(NotImplementedError):
            D.main()


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _kernel_calls():
    from repro_torch.kernels import bdmm, kv_write, monarch, paged, sample

    x, L, R = _meta(8, 64), _meta(8, 8, 8), _meta(8, 8, 8)
    i8 = torch.int8
    q, pages = _meta(2, 1, 4, 16), _meta(3, 16, 4, 16)
    table, ints = _meta(2, 3, dtype=torch.int32), _meta(2, dtype=torch.int32)
    return {
        "B1": lambda: monarch.monarch_fused(x, L, R),
        "B2": lambda: bdmm.bdmm(_meta(8, 8, 8), L),
        "B3": lambda: paged.paged_attention_span(q, pages, pages, table,
                                                 ints, ints),
        "B4": lambda: monarch.monarch_fused_q(
            x, _meta(8, 8, 8, dtype=i8), _meta(8, 1, 1),
            _meta(8, 8, 8, dtype=i8), _meta(8, 1, 1)),
        "B5": lambda: bdmm.bdmm_q(_meta(8, 8, 8), _meta(8, 8, 8, dtype=i8),
                                  _meta(8, 1, 1)),
        "B6": lambda: paged.paged_attention_span(
            q, _meta(3, 16, 4, 16, dtype=i8), _meta(3, 16, 4, 16, dtype=i8),
            table, ints, ints, k_scales=_meta(3, 4), v_scales=_meta(3, 4)),
        "X2": lambda: kv_write.quantize_kv_write(
            _meta(3, 16, 4, 16, dtype=i8), _meta(3, 4),
            _meta(2, 1, dtype=torch.int32), _meta(2, 1, dtype=torch.int32),
            _meta(2, 1, 4, 16)),
        "X3": lambda: sample.sample_tokens(
            _meta(2, 50), _meta(2), _meta(2, 2, dtype=torch.int32),
            _meta(2, dtype=torch.bool), True),
    }


@pytest.mark.parametrize("kernel", ["B1", "B2", "B3", "B4", "B5", "B6", "X2",
                                    "X3"])
def test_a_meta_tensor_reaching_a_kernel_raises(kernel):
    from repro_torch.kernels import launches
    before = launches()
    with pytest.raises(ValueError, match="CUDA device"):
        _kernel_calls()[kernel]()
    assert launches() == before
