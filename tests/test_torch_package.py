"""Package-level contracts of the port: it imports neither JAX nor the
reference package, its entry points run on CUDA unless the caller asks for
the CPU (and raise rather than fall back), ``params_from_numpy`` keeps the
reference's tree, and the kernel build fails loudly without ``nvcc``."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro_torch import resolve_device, tree_map
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import _build
from repro_torch.models import transformer as TT
from repro_torch.serving import ContinuousBatchingEngine

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    pkg = Path(repro_torch.__file__).parent
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages([str(pkg)], "repro_torch.")]


def test_importing_every_module_loads_no_jax_and_no_reference():
    mods = _modules()
    assert "repro_torch.kernels.paged" in mods and len(mods) > 20
    assert {"repro_torch.launch.mesh", "repro_torch.sharding.api",
            "repro_torch.sharding.params",
            "repro_torch.serving.device_kv", "repro_torch.core.d2s",
            "repro_torch.core.permutations",
            "repro_torch.examples.quickstart",
            "repro_torch.checkpoint", "repro_torch.checkpoint.store",
            "repro_torch.ft", "repro_torch.ft.coordinator",
            "repro_torch.serving.snapshot", "repro_torch.serving.faults",
            "repro_torch.serving.replicas"} <= set(mods)
    assert {f"repro_torch.cim.{m}" for m in (
        "spec", "mapping", "scheduling", "cost", "workload", "simulator",
        "dse", "functional")} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_chip_smoke_imports_nothing_of_jax_or_reference():
    src = (ROOT / "chip_smoke.py").read_text()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            top = words[1].split(".")[0]
            assert top not in ("jax", "repro"), line


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda_unless_cpu(no_cuda):
    cfg = get_config("gpt2-medium").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_paged_pool(cfg, 4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"a": np.zeros(2, np.float32)})
    params = TT.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(cfg, params)
    eng = ContinuousBatchingEngine(cfg, params, device="cpu", max_len=16,
                                   page_size=4, max_slots=1)
    assert eng.device.type == "cpu"
    assert resolve_device("cpu") == torch.device("cpu")


def test_params_from_numpy_keeps_keys_shapes_and_dtypes():
    cfg = jget_config("gpt2-medium").reduced()
    jp = JT.init_params(jax.random.PRNGKey(0), cfg)
    jp["extra"] = {"bf16": jnp.ones((3, 2), jnp.bfloat16) * 1.5,
                   "i32": jnp.arange(4, dtype=jnp.int32)}
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = params_from_numpy(tree, device="cpu")
    want = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)), jp)
    got = tree_map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]),
                   tp)
    assert got == want
    assert tp["decoder"]["layers"]["attn"]["wq"]["L"].shape[0] == \
        cfg.n_layers
    np.testing.assert_array_equal(tp["extra"]["bf16"].float().numpy(), 1.5)
    np.testing.assert_array_equal(
        tp["embedding"]["table"].numpy(),
        np.asarray(jp["embedding"]["table"]))


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "CUDA_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()
    # nothing is built, and a cached build is named by its sources' hash
    assert _build.build_all([]) == {}
    assert _build._lib_path("monarch") == _build._lib_path("monarch")
    assert _build._lib_path("monarch") != _build._lib_path("paged")


@pytest.mark.parametrize("raw", [True, False])
def test_stream_of_reads_the_current_stream_with_or_without_the_raw_accessor(
        monkeypatch, raw):
    """The kernels' stream handle comes from torch's private raw accessor
    where the installed torch has it (resolved once, at import), else from
    the public ``torch.cuda.current_stream``; both name the card's current
    stream, and neither path fails for want of the private name."""
    class Card:
        device = "cuda:3"

        def get_device(self):
            return 3

    class Stream:
        cuda_stream = 0x5eed

    assert _build._RAW_STREAM is getattr(torch._C,
                                         "_cuda_getCurrentRawStream", None)
    asked = []
    monkeypatch.setattr(_build, "_RAW_STREAM", (
        lambda d: asked.append(d) or 0x5eed) if raw else None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: asked.append(d) or Stream())
    assert _build.stream_of(Card()) == 0x5eed
    assert asked == ([3] if raw else ["cuda:3"])


def test_cpu_wrappers_count_no_launches():
    from repro_torch.kernels import launches, ops, reset_launches

    reset_launches()
    x = torch.randn(4, 64)
    L, R = torch.randn(4, 4, 16), torch.randn(4, 16, 4)
    ops.monarch_mm(x, L, R)
    ops.bdmm_mm(x.view(4, 4, 16), L)
    from repro_torch.core.quant import quantize_monarch

    qc = quantize_monarch({"L": L, "R": R}, bits=4)
    ops.monarch_mm_q(x, qc["Lq"], qc["Ls"], qc["Rq"], qc["Rs"])
    # stacked experts: the expert-batched wrappers' plain paths
    xe, Le, Re = x.expand(2, 4, 64), L.expand(2, 4, 4, 16), \
        R.expand(2, 4, 16, 4)
    ops.monarch_mm(xe, Le, Re)
    qe = quantize_monarch({"L": Le, "R": Re}, bits=8)
    ops.monarch_mm_q(xe, qe["Lq"], qe["Ls"], qe["Rq"], qe["Rs"])
    from repro_torch.kernels.sample import sample_tokens

    sample_tokens(torch.randn(2, 70), torch.tensor([0.0, 0.9]),
                  torch.zeros(2, 2, dtype=torch.int32),
                  torch.tensor([True, True]), True)
    assert launches() == {"monarch_fused": 0, "bdmm": 0,
                          "paged_attention_span": 0, "monarch_fused_q": 0,
                          "bdmm_q": 0, "paged_attention_span_q": 0,
                          "monarch_fused_experts": 0,
                          "monarch_fused_q_experts": 0,
                          "paged_attention_span_sharded": 0,
                          "paged_attention_span_sharded_q": 0,
                          "quantize_kv_write": 0, "sample_tokens": 0}
