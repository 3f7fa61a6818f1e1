"""``configs/shapes.py``, the ``"data"`` axis's placements and
``examples/d2s_convert.py`` against the JAX reference, on the CPU.

* ``SHAPES``, ``cell_supported``, ``input_specs``, ``enc_out_specs`` and
  ``decode_cache_specs`` (meta tensors) equal the reference's
  ``jax.eval_shape`` in shape and dtype for all twelve configs x four
  shapes; the one designed difference is the Mamba ``conv`` state, stored
  in fp32 (``models/mamba2.py``);
* ``launch.steps.train_shardings`` for every config at full width
  (shapes only: ``FakeTensorMode``) at ``(data, model)`` of (2, 2) and
  (4, 2): every world rank's shard has its placement's shape and the
  shards put back together have the leaf's; every dim the port splits
  over ``"data"`` is the reference's ``spec_for`` dim, but for the leaves
  of :data:`DESIGNED`, where the reference's guard leaves the leaf whole
  and the port splits its first dim that ``data`` divides;
* at ``.reduced()`` widths the shards put back together are
  ``torch.equal`` to each leaf, and ``transformer.init_params(plan=)``,
  which cuts each layer as it is drawn, is ``torch.equal`` to the slices
  of the whole draw on every rank;
* the d2s example's figures on the reference's numpy params equal the
  reference's, and ``python -m repro_torch.examples.d2s_convert --device
  cpu`` runs to its last line.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_numpy_params import numpy_params
from repro.configs import get_config as jget_config
from repro.configs import shapes as JSH
from repro.core.d2s import convert_tree as jconvert_tree
from repro.models import transformer as JT
from repro.sharding.params import spec_for
from repro_torch.configs import PORTED_ARCHS
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import shapes as TSH
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.models import transformer as TT
from repro_torch.sharding.params import _leaves, shard_leaf, unshard_leaf

MESHES = [(2, 2), (4, 2)]      # (data, model)
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32,
          jnp.int32: torch.int32}
# (arch, data, leaf path): the reference's guard leaves the leaf whole
# over "data" (its rule's dim does not divide), the port splits the first
# of the leaf's own dims that data divides (sharding/params.py:fsdp_axis)
DESIGNED = {
    ("codeqwen1.5-7b", 4, "decoder/layers/ffn/w1/R"),
    ("codeqwen1.5-7b", 4, "decoder/layers/ffn/wg/R"),
    ("mamba2-2.7b", 2, "decoder/layers/mamba/in_proj/R"),
    ("mamba2-2.7b", 4, "decoder/layers/mamba/in_proj/R"),
    ("qwen2-moe-a2.7b", 4, "decoder/layers/moe/experts/w1/R"),
    ("qwen2-moe-a2.7b", 4, "decoder/layers/moe/experts/wg/R"),
    *{("qwen2-moe-a2.7b", 4, f"decoder/layers/moe/shared{i}/{w}/R")
      for i in range(4) for w in ("w1", "wg")},
    ("zamba2-7b", 2, "decoder/groups/mamba/in_proj/R"),
    ("zamba2-7b", 2, "decoder/tail/mamba/in_proj/R"),
    ("zamba2-7b", 4, "decoder/groups/mamba/in_proj/R"),
    ("zamba2-7b", 4, "decoder/tail/mamba/in_proj/R"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(data, model, rank=0):
    return Mesh(model=model, data=data, rank=rank, device="cpu")


def _flat_ref(tree) -> dict:
    return {tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree) -> dict:
    return {tuple(p.split("/")): leaf for p, leaf in _leaves(tree)}


# ---------------------------------------------------------------------------
# configs/shapes.py
# ---------------------------------------------------------------------------


def test_shape_cells_are_the_reference_s():
    assert list(TSH.SHAPES) == list(JSH.SHAPES)
    for name, cell in TSH.SHAPES.items():
        assert dataclasses.asdict(cell) == dataclasses.asdict(
            JSH.SHAPES[name])


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_specs_match_reference_for_every_shape(arch):
    jc, tc = jget_config(arch), tget_config(arch)
    for shape in TSH.SHAPES:
        assert TSH.cell_supported(tc, shape) == JSH.cell_supported(jc, shape)
        want = JSH.input_specs(jc, shape)
        got = TSH.input_specs(tc, shape)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == v.shape, (shape, k)
            assert got[k].dtype == DTYPES[v.dtype.type], (shape, k)
        jenc, tenc = JSH.enc_out_specs(jc, shape), TSH.enc_out_specs(tc, shape)
        assert (jenc is None) == (tenc is None)
        if jenc is not None:
            assert tuple(tenc.shape) == jenc.shape
            assert tenc.dtype == DTYPES[jenc.dtype.type]
        jcache = _flat_ref(JSH.decode_cache_specs(jc, shape))
        tcache = _flat_port(TSH.decode_cache_specs(tc, shape))
        assert sorted(tcache) == sorted(jcache)
        for path, v in jcache.items():
            assert tcache[path].device.type == "meta"
            assert tuple(tcache[path].shape) == v.shape, (shape, path)
            want_dt = DTYPES[v.dtype.type]
            if path[-1] == "conv":     # designed: stored in fp32
                want_dt = torch.float32
            assert tcache[path].dtype == want_dt, (shape, path)


# ---------------------------------------------------------------------------
# train_shardings and the placements
# ---------------------------------------------------------------------------


class _AxisSizes:
    """What ``repro.sharding.params.spec_for`` reads of a mesh."""

    def __init__(self, data, model):
        self.axis_names = ("data", "model")
        self.shape = {"data": data, "model": model}


def _ref_data_dim(path, shape, data, model):
    spec = tuple(spec_for(path, tuple(shape), _AxisSizes(data, model)))
    for i, ax in enumerate(spec):
        if ax == "data":
            return i - len(shape)
    return None


def _placement(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("data,model", MESHES)
def test_train_shardings_place_every_leaf_at_full_width(data, model):
    from torch._subclasses.fake_tensor import FakeTensorMode

    designed = set()
    for arch in PORTED_ARCHS:
        cfg = tget_config(arch)
        ts = TS.train_shardings(cfg, _mesh(data, model), "train_4k")
        for k, v in TSH.input_specs(cfg, "train_4k").items():
            assert tuple(ts.batch_shape[k].shape) == tuple(v.shape)
            assert ts.batch[k] == v.shape[0] // data
        assert ts.state_shape["opt"].step.dtype == torch.int32
        assert ts.state["opt"].mu is ts.state["params"]
        plans = [TS.train_plan(cfg, _mesh(data, model, r))[0]
                 for r in range(data * model)]
        with FakeTensorMode():
            for path, meta in _leaves(ts.state_shape["params"]):
                pl = _placement(ts.state["params"], path)
                assert pl.shape == tuple(meta.shape)
                leaf = torch.empty(meta.shape, dtype=meta.dtype)
                parts = [shard_leaf(leaf, pl, p) for p in plans]
                assert all(tuple(t.shape) == pl.shard for t in parts), path
                assert tuple(unshard_leaf(parts, pl, plans[0]).shape) \
                    == pl.shape, path
                ref = _ref_data_dim(path, meta.shape, data, model)
                if pl.fsdp != ref:
                    assert ref is None and pl.fsdp is not None, path
                    designed.add((arch, data, path))
    assert designed == {d for d in DESIGNED if d[1] == data}


REDUCED = ["gpt2-medium", "granite-moe-1b-a400m", "qwen2-moe-a2.7b",
           "mamba2-2.7b", "zamba2-7b", "seamless-m4t-large-v2"]


@pytest.mark.parametrize("data,model", MESHES)
@pytest.mark.parametrize("arch", REDUCED)
def test_shards_put_back_together_and_init_cuts_as_it_draws(arch, data,
                                                            model):
    """Every rank's ``init_params(plan=)`` is ``torch.equal`` to its slices
    of the whole draw, and every rank's slices put back together are the
    whole leaf."""
    cfg = tget_config(arch).reduced()
    whole = TT.init_params(cfg, seed=7, device="cpu")
    plans, tables = zip(*(TS.train_plan(cfg, _mesh(data, model, r))
                          for r in range(data * model)))
    drawn = [TT.init_params(cfg, seed=7, device="cpu", plan=p)
             for p in plans]
    split_somewhere = False
    for path, leaf in _leaves(whole):
        pl = tables[0][path]
        parts = [shard_leaf(leaf, pl, p) for p in plans]
        for r, part in enumerate(parts):
            got = dict(_leaves(drawn[r]))[path]
            assert torch.equal(got, part), (path, r)
            assert tuple(got.shape) == pl.shard
        assert torch.equal(unshard_leaf(parts, pl, plans[0]), leaf), path
        split_somewhere |= pl.fsdp is not None
    assert split_somewhere


def test_new_modules_are_among_the_package_s():
    """tests/test_torch_package.py imports each of them in a process that
    must load no JAX and no reference module."""
    from test_torch_package import _modules

    assert {"repro_torch.configs.shapes", "repro_torch.examples.d2s_convert",
            "repro_torch.launch.steps", "repro_torch.launch.mesh",
            "repro_torch.train.trainer"} <= set(_modules())


def test_mesh_positions_and_refusals():
    m = _mesh(2, 2, rank=2)
    assert (m.data_rank, m.model_rank, m.world) == (1, 0, 4)
    with pytest.raises(ValueError, match="rank"):
        _mesh(2, 2, rank=4)
    with pytest.raises(ValueError, match="data"):
        run_ranks(print, 4, backend="gloo", device="cpu", data=3)
    with pytest.raises(ValueError, match="nccl"):
        Mesh(model=2, data=2, backend="nccl", device="cpu")


# ---------------------------------------------------------------------------
# examples/d2s_convert.py
# ---------------------------------------------------------------------------


def _reference_figures(jcfg, npp, tokens):
    """The reference example's body (examples/d2s_convert.py) on given
    params and tokens."""
    params = jax.tree_util.tree_map(jnp.asarray, npp)

    def select(path, leaf):
        return any(s in path for s in ("wq", "wk", "wv", "wo", "w1", "w2",
                                       "wg", "in_proj", "out_proj"))

    sparse, reports = jconvert_tree(params, select)
    worst = max(reports, key=lambda r: r.rel_error)
    t = jnp.asarray(tokens)
    ld, _ = JT.forward(params, {"tokens": t}, jcfg, train=False)
    ls, _ = JT.forward(sparse, {"tokens": t}, jcfg, train=False)
    pd, ps = jax.nn.softmax(ld, -1), jax.nn.softmax(ls, -1)
    tv = float(0.5 * jnp.mean(jnp.sum(jnp.abs(pd - ps), axis=-1)))
    return {"n_converted": len(reports),
            "dense_params": sum(r.dense_params for r in reports),
            "sparse_params": sum(r.sparse_params for r in reports),
            "worst_rel_error": worst.rel_error, "worst_name": worst.name,
            "tv": tv}


def test_d2s_example_figures_equal_reference():
    from repro_torch.examples import d2s_convert

    jc = jget_config("bert-large-lm:dense").reduced()
    tc = tget_config("bert-large-lm:dense").reduced()
    npp = numpy_params(jc, seed=4)
    tokens = np.random.default_rng(1).integers(0, tc.vocab, (2, 16))
    want = _reference_figures(jc, npp, tokens)
    got = d2s_convert.convert_and_compare(
        params_from_numpy(npp, device="cpu"), tc, torch.from_numpy(tokens))
    for k in ("n_converted", "dense_params", "sparse_params", "worst_name"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["worst_rel_error"],
                               want["worst_rel_error"], rtol=1e-5)
    np.testing.assert_allclose(got["tv"], want["tv"], rtol=1e-4, atol=1e-6)
    assert d2s_convert.report_lines(got)[:2] == \
        d2s_convert.report_lines(want)[:2]


def test_d2s_example_runs_on_the_cpu(capsys):
    from repro_torch.examples import d2s_convert

    assert d2s_convert.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("converted ")
    assert out[-1] == "d2s_convert OK"
