"""The port's D2S projection (``repro_torch.core.d2s``) and permutations
against the JAX reference, on the CPU.

The same numpy dense weights go through ``repro.core.d2s`` and
``repro_torch.core.d2s``.  SVD signs differ between XLA's and LAPACK's
drivers, so the raw factors are never compared: the Monarch matrix they
represent (``monarch_to_dense(L, R)``) is, as Frobenius distance relative
to ||M||,

* within 1e-6 of the projection computed independently in float64 with
  numpy (the port takes its leading triples in float64 and rounds the
  factors to fp32: observed 4.4e-8);
* within the reference's own distance from that projection plus 1e-6 of
  the reference's (the reference takes fp32 triples: 1e-6 to 3e-5 from
  float64, more where a slice's two largest singular values nearly tie),
  and within 1e-5 at the reduced models' shapes.

Projection errors agree within 1e-5; reports' names, dims and compression
are identical.  The converted models' logits are held at 1e-4, the port's
fp32 logits tolerance (tests/test_torch_models.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import d2s as jd2s
from repro.core import monarch as jmn
from repro.core import permutations as jperms
from repro.models import transformer as JT
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import d2s
from repro_torch.core import monarch as mn
from repro_torch.core import permutations as perms
from repro_torch.models import transformer as TT

FP64_REL = 1e-6
MATRIX_REL = 1e-5
ERROR_ABS = 1e-5
LOGITS = dict(rtol=1e-4, atol=1e-4)   # tests/test_torch_models.py


def _rel_frob(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _float64_projection(w: np.ndarray, dims) -> np.ndarray:
    """The dense Monarch projection of ``w``, leading triples by numpy's
    float64 SVD."""
    k, q, p, s = dims.k, dims.q, dims.p, dims.s
    w4 = w.astype(np.float64).reshape(k, p, q, s).transpose(0, 2, 1, 3)
    u, sv, vt = np.linalg.svd(w4, full_matrices=False)
    m4 = sv[..., 0, None, None] * u[..., :, 0, None] * vt[..., 0, None, :]
    return m4.transpose(0, 2, 1, 3).reshape(k * p, q * s)


def _select(path, leaf):
    return any(s in path for s in ("wq", "wk", "wv", "wo", "w1", "w2", "wg"))


# ---------------------------------------------------------------------------
# project_to_monarch / projection_error against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("din,dout,policy", [
    (64, 64, "paper"),        # square, b = 8
    (64, 256, "paper"),       # FFN up
    (256, 64, "paper"),       # FFN down, k != q
    (96, 120, "paper"),       # non-power-of-two
    (256, 512, "mxu128"),     # 128-aligned blocks
])
def test_project_to_monarch_matches_reference(din, dout, policy):
    w = np.random.default_rng(din + dout).standard_normal(
        (din, dout)).astype(np.float32)
    dims = mn.make_dims(din, dout, policy=policy)
    jdims = jmn.make_dims(din, dout, policy=policy)
    assert dims == mn.MonarchDims(jdims.din, jdims.dout, jdims.k, jdims.q)
    jL, jR = jd2s.project_to_monarch(jnp.asarray(w), jdims)
    L, R = d2s.project_to_monarch(torch.from_numpy(w), dims)
    assert tuple(L.shape) == dims.l_shape and tuple(R.shape) == dims.r_shape
    assert L.dtype == torch.float32 and R.dtype == torch.float32
    got = mn.monarch_to_dense(L, R).numpy()
    want = np.asarray(jmn.monarch_to_dense(jL, jR))
    exact = _float64_projection(w, dims)
    assert _rel_frob(got, exact) <= FP64_REL
    assert _rel_frob(got, want) <= _rel_frob(want, exact) + FP64_REL
    err = float(d2s.projection_error(torch.from_numpy(w), L, R))
    jerr = float(jd2s.projection_error(jnp.asarray(w), jL, jR))
    assert abs(err - jerr) <= ERROR_ABS and 0.0 < err < 1.0


def test_stacked_projection_is_each_slice_projected():
    """A stacked (n, din, dout) weight is projected in one batch: each
    slice equals its own projection, and the error is per slice."""
    w = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 64, 128)).astype(np.float32))
    dims = mn.make_dims(64, 128)
    L, R = d2s.project_to_monarch(w, dims)
    assert tuple(L.shape) == (3, *dims.l_shape)
    assert tuple(R.shape) == (3, *dims.r_shape)
    errs = d2s.projection_error(w, L, R)
    assert tuple(errs.shape) == (3,)
    dense = mn.monarch_to_dense(L, R)
    for i in range(3):
        Li, Ri = d2s.project_to_monarch(w[i], dims)
        np.testing.assert_allclose(dense[i].numpy(),
                                   mn.monarch_to_dense(Li, Ri).numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert abs(float(errs[i]) - float(
            d2s.projection_error(w[i], Li, Ri))) <= 1e-6


# ---------------------------------------------------------------------------
# convert_tree over reduced dense models, and the converted models' logits
# ---------------------------------------------------------------------------


def _leaf(tree, path: str):
    for key in path[2:-2].split("']['"):
        tree = tree[key]
    return tree


@pytest.mark.parametrize("arch", ["bert-large-lm", "gpt2-medium"])
def test_convert_tree_matches_reference(arch):
    jc = jget_config(f"{arch}:dense").reduced()
    tc = tget_config(f"{arch}:dense").reduced()
    jp = JT.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    jnew, jrep = jd2s.convert_tree(jp, _select)
    tnew, trep = d2s.convert_tree(tp, _select)
    assert [(r.name, r.din, r.dout, r.dims.k, r.dims.q, r.dense_params,
             r.sparse_params, r.compression) for r in trep] == [
        (r.name, r.din, r.dout, r.dims.k, r.dims.q, r.dense_params,
         r.sparse_params, r.compression) for r in jrep]
    assert {r.name.split("']['")[-2] for r in trep} == {
        "wq", "wk", "wv", "wo", "w1", "w2"}
    for r, jr in zip(trep, jrep):
        assert abs(r.rel_error - jr.rel_error) <= ERROR_ABS
        got, want = _leaf(tnew, r.name), _leaf(jnew, r.name)
        assert set(got) == {"L", "R"}
        assert tuple(got["L"].shape) == tuple(want["L"].shape)
        assert _rel_frob(mn.monarch_to_dense(got["L"], got["R"]).numpy(),
                         np.asarray(jax.vmap(jmn.monarch_to_dense)(
                             want["L"], want["R"]))) <= MATRIX_REL
    # what was not selected is the same tensor
    assert tnew["embedding"]["table"] is tp["embedding"]["table"]
    tokens = np.random.default_rng(1).integers(0, jc.vocab, (2, 16),
                                               dtype=np.int32)
    want, _ = JT.forward(jnew, {"tokens": jnp.asarray(tokens)}, jc,
                         train=False)
    got, _ = TT.forward(tnew, {"tokens": torch.from_numpy(tokens)}, tc,
                        train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def test_convert_tree_paths_are_keystr_in_reference_order():
    tree = {"b": {"w": np.ones((8, 8), np.float32)},
            "a": {"z": {"w": np.ones((2, 8, 16), np.float32)},
                  "bias": np.zeros(8, np.float32)}}
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(tree)[0]]
    seen = []
    _, rep = d2s.convert_tree(params_from_numpy(tree, device="cpu"),
                              lambda path, leaf: seen.append(path) or True)
    assert seen == [p for p in jpaths if "bias" not in p]
    assert [r.name for r in rep] == seen


# ---------------------------------------------------------------------------
# the reference's own D2S properties (tests/test_monarch_core.py:93-130)
# ---------------------------------------------------------------------------


def test_d2s_exact_recovery_of_monarch_matrix():
    """Projection must be exact when W already is Monarch (rank-1 slices)."""
    dims = mn.MonarchDims(din=64, dout=64, k=8, q=8)
    gen = torch.Generator().manual_seed(3)
    params = mn.init_monarch(gen, dims)
    w = mn.monarch_to_dense(params["L"], params["R"])
    L, R = d2s.project_to_monarch(w, dims)
    err = d2s.projection_error(w, L, R)
    assert float(err) < 1e-5, f"exact recovery failed: rel err {float(err)}"


def test_d2s_is_optimal_vs_perturbations():
    """Frobenius optimality: projection error <= error of perturbed factors."""
    gen = torch.Generator().manual_seed(4)
    w = torch.randn((64, 64), generator=gen)
    dims = mn.MonarchDims(din=64, dout=64, k=8, q=8)
    L, R = d2s.project_to_monarch(w, dims)
    base = float(d2s.projection_error(w, L, R))
    for seed in range(3):
        dL = 0.01 * torch.randn(L.shape,
                                generator=torch.Generator().manual_seed(
                                    10 + seed))
        perturbed = float(d2s.projection_error(w, L + dL, R))
        assert base <= perturbed + 1e-7


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_d2s_error_bounded_for_random(bits):
    """Relative error of projecting an iid Gaussian stays < 1."""
    n = 4 ** bits if 4 ** bits >= 16 else 16
    k = int(np.sqrt(n))
    w = torch.randn((n, n), generator=torch.Generator().manual_seed(bits))
    dims = mn.MonarchDims(din=n, dout=n, k=k, q=k)
    L, R = d2s.project_to_monarch(w, dims)
    err = float(d2s.projection_error(w, L, R))
    assert 0.0 < err < 1.0


def test_convert_tree_selects_and_reports():
    gen = torch.Generator().manual_seed(0)
    params = {
        "attn": {"wq": torch.randn((64, 64), generator=gen)},
        "ln": {"scale": torch.ones((64,))},
        "ffn": {"w1": torch.randn((64, 256), generator=gen)},
    }
    new, reports = d2s.convert_tree(
        params, select=lambda path, leaf: "wq" in path or "w1" in path)
    assert "L" in new["attn"]["wq"] and "R" in new["ffn"]["w1"]
    np.testing.assert_array_equal(new["ln"]["scale"].numpy(), np.ones((64,)))
    assert [r.name for r in reports] == ["['attn']['wq']", "['ffn']['w1']"]
    for r in reports:
        assert r.compression > 1.0


# ---------------------------------------------------------------------------
# permutations: the same identities, numpy helpers identical to the
# reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,q", [(4, 4), (4, 8), (8, 2), (3, 5)])
def test_stride_perm_matches_reference_and_inverts(k, q):
    np.testing.assert_array_equal(perms.stride_perm_indices(k, q),
                                  jperms.stride_perm_indices(k, q))
    P = perms.stride_perm_matrix(k, q)
    np.testing.assert_array_equal(P, jperms.stride_perm_matrix(k, q))
    np.testing.assert_array_equal(P @ perms.stride_perm_matrix(q, k),
                                  np.eye(k * q, dtype=np.float32))
    x = np.random.default_rng(k * q).standard_normal((3, k * q)).astype(
        np.float32)
    y = perms.apply_stride_perm(torch.from_numpy(x), k, q)
    np.testing.assert_allclose(y.numpy(), x @ P, rtol=0, atol=0)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jperms.apply_stride_perm(jnp.asarray(x), k, q)))
    np.testing.assert_array_equal(
        perms.apply_stride_perm(y, q, k).numpy(), x)


@pytest.mark.parametrize("shift", [-3, -1, 0, 2, 5])
def test_rotate_blocks_matches_reference_and_inverts(shift):
    x = np.random.default_rng(7).standard_normal((2, 24)).astype(np.float32)
    got = perms.rotate_blocks(torch.from_numpy(x), shift, 6)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jperms.rotate_blocks(jnp.asarray(x), shift,
                                                     6)))
    np.testing.assert_array_equal(
        perms.rotate_blocks(got, -shift, 6).numpy(), x)


def test_block_diag_dense_matches_reference():
    blocks = np.random.default_rng(2).standard_normal((3, 2, 4))
    np.testing.assert_array_equal(perms.block_diag_dense(blocks),
                                  jperms.block_diag_dense(blocks))


def test_paper_form_equals_folded_monarch():
    """M = P . L . P . R . P (paper Eq. 1, square case) is the folded
    ``monarch_to_dense``, and equals the reference's materialization."""
    dims = mn.MonarchDims(din=64, dout=64, k=8, q=8)
    f = mn.init_monarch(torch.Generator().manual_seed(1), dims,
                        dtype=torch.float64)
    dense = perms.paper_form_dense(f["L"].numpy(), f["R"].numpy())
    np.testing.assert_allclose(dense, mn.monarch_to_dense(
        f["L"], f["R"]).numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(dense, jperms.paper_form_dense(
        f["L"].numpy(), f["R"].numpy()), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# the port's quickstart, on the CPU
# ---------------------------------------------------------------------------


def test_quickstart_runs_on_the_cpu(capsys):
    from repro_torch.examples import quickstart

    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "quickstart OK"
    assert any("6 matmuls converted" in line for line in out)
