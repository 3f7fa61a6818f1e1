"""The int8 KV write's wrapper (``kernels.kv_write``) on the CPU: it is
``core.quant.quantize_kv_write`` for CPU tensors and counts no launch; the
kernel's three steps in plain PyTorch (``_phased``, a mirror of
``csrc/kv_write.cu``: slots, last writers, one rescale a distinct page) are bitwise that plain
version on every page and scale, the sink included (the plain version run
under ``torch.use_deterministic_algorithms``, whose index_put keeps the
last of duplicate indices, as the kernel does; otherwise a large enough
write resolves the sink's duplicates in no fixed order); and both hold the JAX
reference (``repro.core.quant.quantize_kv_write``) on the same numpy
inputs bitwise, on every page but the sink (page 0, where padding writes
land in an order the reference does not fix) and on every scale.

The writes are built as the model builds them (``models/layers.py``:
phys/off from the page table, positions past a row's span redirected to
the sink, the rescale set ``ceil(S / page) + 1`` columns from the span's
first page, clamped to the table), over chained steps: fresh pages, scale
growth, a recycled page reset inside the rescale set, pages listed twice
in the rescale set (the sink, a shared page, the clamped last column of a
page that grows), S = 1, and nemotron-4-15b's KV = 8 / hd = 128."""

import contextlib
from typing import Optional

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.core import quant as tq
from repro_torch.kernels import _build, kv_write, launches, reset_launches


def _state(rng, P, pg, KV, hd):
    """Pages and scales holding quantized random rows (page 0 too)."""
    rows = rng.standard_normal((P, pg, KV, hd)).astype(np.float32)
    q, s = tq.quantize_kv_page(torch.from_numpy(rows))
    return q, s


def _write(rng, pt, start, span, S, pg, KV, hd, scale=1.0, bf16=False):
    """One step's write arguments as ``models/layers.py`` derives them."""
    B, MP = pt.shape
    pt = torch.from_numpy(pt).long()
    q_pos = torch.from_numpy(np.asarray(start)).long()[:, None] + \
        torch.arange(S)[None, :]
    phys = torch.gather(pt, 1, torch.clamp(q_pos // pg, max=MP - 1))
    off = q_pos % pg
    valid = torch.arange(S)[None, :] < torch.tensor(span)[:, None]
    phys = torch.where(valid, phys, torch.zeros_like(phys))
    nK = (S + pg - 1) // pg + 1
    cols = torch.clamp(q_pos[:, :1] // pg + torch.arange(nK)[None, :], 0,
                       MP - 1)
    resc = torch.gather(pt, 1, cols)
    rows = torch.from_numpy(
        (rng.standard_normal((B, S, KV, hd)) * scale).astype(np.float32))
    return phys, off, rows.to(torch.bfloat16) if bf16 else rows, resc


def _phased(pages: torch.Tensor, scales: torch.Tensor, phys: torch.Tensor,
            off: torch.Tensor, rows: torch.Tensor,
            rescale_phys: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """csrc/kv_write.cu's three launches in plain PyTorch, in place: slots,
    candidate scales, reset and touched flags and each (slot, offset)'s
    last writer; then each flagged slot's new scale and, for a rescale-set
    slot, its stored rows rescaled; then each writer's row stored under the
    final scale."""
    B, S = phys.shape
    KV, pg = scales.shape[1], pages.shape[1]
    rp = (phys if rescale_phys is None else rescale_phys).reshape(-1)
    rp, ph, of = rp.tolist(), phys.reshape(-1).tolist(), off.reshape(-1)
    of = of.tolist()
    n_rp, n = len(rp), len(ph)
    flat = rows.float().reshape(n, KV, -1)

    def slot_of(page: int, i: int) -> int:
        if page in rp:
            return rp.index(page)
        if page == 0:
            return n_rp
        return n_rp + 1 + ph[:i + 1].index(page)

    # 1. kv_scales_kernel
    cand = torch.zeros(n_rp + 1 + n, KV)
    flag = [0] * (n_rp + 1 + n)
    writer: dict[tuple[int, int], int] = {}
    slot = []
    c = tq._div(flat.abs().amax(dim=-1), tq.KV_QMAX)
    for i in range(n):
        s = slot_of(ph[i], i)
        r = s if of[i] == 0 else slot_of(0, i)
        slot.append(s)
        flag[s] |= 2
        flag[r] |= 1
        cand[s] = torch.maximum(cand[s], c[i])
        writer[s, of[i]] = i
    # 2. kv_rescale_kernel
    for e, fl in enumerate(flag):
        if not fl:
            continue
        p = rp[e] if e < n_rp else 0 if e == n_rp else ph[e - n_rp - 1]
        s0 = torch.zeros(KV) if fl & 1 else scales[p].clone()
        s1 = torch.maximum(cand[e], s0)
        ratio = torch.where(s1 > 0, s0 / s1, torch.ones_like(s1))
        scales[p] = s1
        cand[e] = s1
        if e < n_rp:
            pages[p] = torch.round(pages[p].float()
                                   * ratio[None, :, None]).to(torch.int8)
    # 3. kv_store_kernel
    for i in range(n):
        if writer[slot[i], of[i]] != i:
            continue
        s1 = cand[slot[i]]
        q = torch.round(flat[i] / torch.where(s1 > 0, s1,
                                              torch.ones_like(s1))[:, None])
        pages[ph[i], of[i]] = torch.clamp(q, -tq.KV_QMAX,
                                          tq.KV_QMAX).to(torch.int8)
    return pages, scales


@contextlib.contextmanager
def _last_wins():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _all_three(pages, scales, ref, args):
    """One write through the wrapper (plain on the CPU), the phased
    mirror and the reference; each kept state is updated.  Returns the
    states (wrapper, phased, reference)."""
    (pw, pp), (sw, sp), (jp, js) = pages, scales, ref
    phys, off, rows, resc = args
    with _last_wins():
        got = kv_write.quantize_kv_write(pw, sw, phys, off, rows,
                                         rescale_phys=resc)
    assert got[0] is pw and got[1] is sw
    _phased(pp, sp, phys, off, rows,
                                      rescale_phys=resc)
    jp, js = jq.quantize_kv_write(
        jp, js, jnp.asarray(phys.numpy(), jnp.int32),
        jnp.asarray(off.numpy(), jnp.int32),
        jnp.asarray(rows.float().numpy()),
        rescale_phys=jnp.asarray(resc.numpy(), jnp.int32))
    assert torch.equal(pp, pw) and torch.equal(sp, sw)
    np.testing.assert_array_equal(pw.numpy()[1:], np.asarray(jp)[1:])
    np.testing.assert_array_equal(sw.numpy(), np.asarray(js))
    return jp, js


def _three_states(q, s):
    return ((q.clone(), q.clone()), (s.clone(), s.clone()),
            (jnp.asarray(q.numpy()), jnp.asarray(s.numpy())))


@pytest.mark.parametrize("KV,hd", [(2, 8), (8, 128)])
@pytest.mark.parametrize("S", [1, 6, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_write_chained_steps_match_plain_phased_and_reference(KV, hd, S,
                                                                 dtype):
    """Four chained steps over 4 rows: a row that starts a recycled page
    at offset 0, a row near the end of its table (the clamp repeats its
    last, growing page in the rescale set), an inert row (all sink) and a
    row whose rescale set holds a shared page another row holds too."""
    rng = np.random.default_rng(S * 100 + KV)
    pg, MP = 4, 6
    P = 1 + 4 * MP
    q, s = _state(rng, P, pg, KV, hd)
    pages, scales, ref = _three_states(q, s)
    pt = 1 + np.arange(4 * MP, dtype=np.int32).reshape(4, MP)
    pt[2] = 0                       # an inert row: every entry the sink
    pt[3, 1] = pt[0, 5]             # a shared page in row 3's rescale set
    end = MP * pg - S
    for step in range(4):
        # row 3 rewrites its first page only, so that no two rows write
        # one (page, offset) but at the sink
        start = [min(step * S, end), min(end - 1 + step, end), 0, 0]
        span = [S, S, 0, min(S, 3)]
        args = _write(rng, pt, start, span, S, pg, KV, hd,
                      scale=1.0 + 2.0 * step, bf16=dtype == "bfloat16")
        ref = _all_three(pages, scales, ref, args)


def test_duplicate_rescale_pages_are_harmless():
    """One rescale set naming the sink twice, a shared page twice (ratio
    exactly 1.0) and a page that grows twice (ratio < 1): each is rescaled
    once, as the plain version's gather-before-scatter does."""
    rng = np.random.default_rng(7)
    P, pg, KV, hd = 8, 4, 2, 8
    q, s = _state(rng, P, pg, KV, hd)
    pages, scales, ref = _three_states(q, s)
    phys = torch.tensor([[5, 5, 0], [3, 0, 0]])
    off = torch.tensor([[2, 3, 1], [1, 2, 3]])
    rows = torch.from_numpy(
        (rng.standard_normal((2, 3, KV, hd)) * 50.0).astype(np.float32))
    resc = torch.tensor([[5, 5, 0, 6], [3, 6, 0, 0]])
    before = s.clone()
    _all_three(pages, scales, ref, (phys, off, rows, resc))
    assert bool((scales[0][5] > before[5]).all())   # page 5 grew: ratio < 1
    assert torch.equal(scales[0][6], before[6])     # the shared page kept
    assert torch.equal(pages[0][6], q[6])


def test_reset_page_inside_the_rescale_set():
    """A row written at offset 0 is its page's first: the page's scale
    restarts from the new rows alone and its stored rows (a previous
    owner's) scale by 0."""
    rng = np.random.default_rng(3)
    P, pg, KV, hd = 6, 4, 2, 8
    q, s = _state(rng, P, pg, KV, hd)
    pages, scales, ref = _three_states(q, s)
    phys, off = torch.tensor([[2, 2]]), torch.tensor([[0, 1]])
    rows = torch.from_numpy(
        (rng.standard_normal((1, 2, KV, hd)) * 1e-3).astype(np.float32))
    _all_three(pages, scales, ref, (phys, off, rows, torch.tensor([[2, 3]])))
    amax = rows.abs().amax(dim=(1, 3))[0]
    assert torch.equal(scales[0][2], tq._div(amax, tq.KV_QMAX))
    assert not pages[0][2, 2:].any()


def test_page_outside_the_rescale_set_moves_its_scale_only():
    """A page the rescale set omits (the model never passes one) takes
    its new scale, and its stored rows stay as stored: the plain
    version's meaning, which the kernel's first-position slot keeps."""
    rng = np.random.default_rng(5)
    P, pg, KV, hd = 6, 4, 2, 8
    q, s = _state(rng, P, pg, KV, hd)
    pages, scales, ref = _three_states(q, s)
    phys, off = torch.tensor([[4, 4, 1]]), torch.tensor([[1, 2, 3]])
    rows = torch.from_numpy(
        (rng.standard_normal((1, 3, KV, hd)) * 40.0).astype(np.float32))
    _all_three(pages, scales, ref, (phys, off, rows, torch.tensor([[1]])))
    assert torch.equal(pages[0][4, 0], q[4, 0])


def test_cpu_wrapper_counts_no_launch_and_the_default_rescale_set():
    rng = np.random.default_rng(1)
    q, s = _state(rng, 5, 4, 2, 8)
    p1, s1, p2, s2 = q.clone(), s.clone(), q.clone(), s.clone()
    phys, off = torch.tensor([[1, 2], [3, 0]]), torch.tensor([[3, 0], [2, 1]])
    rows = torch.from_numpy(rng.standard_normal((2, 2, 2, 8))
                            .astype(np.float32))
    reset_launches()
    kv_write.quantize_kv_write(p1, s1, phys, off, rows)
    assert launches()["quantize_kv_write"] == 0
    _phased(p2, s2, phys, off, rows)
    assert torch.equal(p1, p2) and torch.equal(s1, s2)


def test_kernel_request_without_a_card_raises(monkeypatch, tmp_path):
    """A tensor on neither the CPU nor one CUDA device raises; the
    kernel's library cannot be built without ``nvcc``; the scratch holds
    every slot the kernel addresses."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kv_write.quantize_kv_write(
            torch.zeros((3, 4, 2, 8), dtype=torch.int8, **meta),
            torch.zeros((3, 2), **meta),
            torch.zeros((1, 2), dtype=torch.long, **meta),
            torch.zeros((1, 2), dtype=torch.long, **meta),
            torch.zeros((1, 2, 2, 8), **meta))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "CUDA_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library("kv_write", "kv_write_launch", kv_write._ARGTYPES)
    assert "kv_write" in _build.SOURCES
    B, S, K, KV, pg = 8, 64, 5, 16, 16
    E = B * K + 1 + B * S
    assert kv_write.scratch_words(B, S, K, KV, pg) == E * (KV + 1 + pg) \
        + B * S
