"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) in PyTorch (port of
``repro.models.mamba2``).

The chunked SSD algorithm serves full sequences (quadratic within a chunk,
the state passed linearly from chunk to chunk), and the O(1) recurrent
step serves decode.  ``ssd_reference`` is the sequential oracle.  The in
and out projections are parameterized matmuls through ``core.linear``, so
they are Monarch-factorized like every other projection (B1/B2 on the
card).

Where the reference scans (``lax.scan`` over the chunks in
``ssd_chunked``, over the positions in ``ssd_reference``), the port loops.
Numerics follow the reference: the softplus is ``jax.nn.softplus``'s
``logaddexp(x, 0)`` (``F.softplus`` turns into the identity above its
threshold), the state runs in fp32, and the gated RMSNorm normalises in
fp32 with eps 1e-6, casts to the activation dtype, then scales.  dtypes
promote as JAX promotes (bf16 activations against fp32 parameters give
fp32): elementwise operators promote by themselves, and the einsums, which
refuse mixed inputs, get their operands promoted first.

``mamba_apply`` with a cache (the recurrent S = 1 step) writes the new
``conv`` and ``ssm`` states into the cache IN PLACE, where the reference
returns a new cache: the legacy engine's decode step is one CUDA graph
whose cache is static.  So the ``conv`` state is stored in fp32, whatever
its dtype: the reference's state takes the dtype of its window after the
first step (the model dtype promoted with the in projection's output,
fp32 where bf16 activations meet fp32 parameters on the einsum path), and
a fixed bf16 buffer would round it.  The step reads the state at that
window dtype, so the arithmetic is the reference's at either.

Under a tensor-parallel plan that splits ``"ssm_heads"``
(``sharding.params``) a rank runs its ``H / tp`` SSM heads: ``in_proj``
is whole on every rank and its output is sliced to the rank's ``z``,
``x`` and ``dt`` (``B`` and ``C``, one group, whole), the depthwise conv
runs on the rank's ``x`` channels plus ``B`` and ``C``, the SSM on its
heads, and ``out_proj`` is row-parallel (one all-reduce).  The gated
RMSNorm normalises over the WHOLE ``d_inner``, so the ranks' fp32 sums
of squares are summed by one more all-reduce before the ``rsqrt``.

For training, each rank's use of a whole value is marked
(``sharding.api.copy_to``) where its parts part ways: ``z``, ``x`` and
``dt`` before the rank slices them, ``B`` and ``C`` after the conv, so
that ``in_proj`` and the conv's ``B``/``C`` channels, whole on every
rank, get the whole gradient; the norm's statistic is summed in the
backward pass as well (``reduce_both``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.linear import linear_apply, linear_init
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _promote
from repro_torch.sharding.api import copy_to, reduce_both


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, nheads, conv_dim


def _model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _repeat(t: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """``jnp.repeat(t, rep, axis=dim)``: each group's slice ``rep`` times
    in a row (an expand, so nothing is read on the host inside a CUDA
    graph's capture)."""
    shape = list(t.shape)
    t = t.unsqueeze(dim + 1).expand(*shape[:dim + 1], rep, *shape[dim + 1:])
    shape[dim] *= rep
    return t.reshape(shape)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, exact at every x."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters in the reference's layout and at its scales
    (not its values)."""
    s = cfg.ssm
    d = cfg.d_model
    dev = gen.device
    d_inner, nheads, conv_dim = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + nheads
    lo, hi = s.a_init_range

    def uniform(n, a, b):
        return a + (b - a) * torch.rand((n,), generator=gen, device=dev)

    a_init = uniform(nheads, lo, hi)
    dt = torch.exp(uniform(nheads, math.log(1e-3), math.log(1e-1)))
    return {
        "in_proj": linear_init(gen, d, d_in_proj, spec=cfg.monarch),
        "conv_w": torch.randn((s.d_conv, conv_dim), generator=gen,
                              device=dev) * (1.0 / math.sqrt(s.d_conv)),
        "conv_b": torch.zeros((conv_dim,), device=dev),
        "A_log": torch.log(a_init),
        "D": torch.ones((nheads,), device=dev),
        "dt_bias": torch.log(torch.expm1(dt)),
        "norm_scale": torch.ones((d_inner,), device=dev),
        "out_proj": linear_init(gen, d_inner, d, spec=cfg.monarch,
                                w_init_scale=1.0 / math.sqrt(
                                    2 * cfg.n_layers)),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums: out[..., i, j] = sum_{j < k <= i}
    a_k, and -inf above the diagonal."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return torch.where(mask, out, torch.full_like(out, -math.inf))


def ssd_chunked(x, dt, A, B, C, chunk: int, init_state=None):
    """Chunked SSD.

    x: (b, S, H, P)   dt: (b, S, H)   A: (H,) negative
    B, C: (b, S, G, N) with G groups, heads H = G * (H // G)
    Returns (y (b, S, H, P) in x's dtype, final_state (b, H, P, N) fp32).
    S must be a multiple of the chunk (or below it), as in the reference.
    """
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Q = min(chunk, S)
    assert S % Q == 0, (S, Q)
    nc = S // Q

    f32 = torch.float32
    xq = x.reshape(b, nc, Q, H, P).to(f32)
    dtq = dt.reshape(b, nc, Q, H).to(f32)
    Bq = _repeat(B.reshape(b, nc, Q, G, N), rep, 3).to(f32)   # (b,nc,Q,H,N)
    Cq = _repeat(C.reshape(b, nc, Q, G, N), rep, 3).to(f32)

    a = dtq * A.to(f32)[None, None, None, :]                   # (b,nc,Q,H)
    a_hqt = torch.movedim(a, -1, 2)                            # (b,nc,H,Q)
    Ldec = torch.exp(_segsum(a_hqt))                           # (b,nc,H,Q,Q)

    xdt = xq * dtq[..., None]                                  # (b,nc,Q,H,P)

    # intra-chunk (diagonal blocks): y[i] = sum_{j<=i} C_i.B_j decay xdt_j
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cq, Bq) * Ldec
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores, xdt)

    # chunk states: S_c = sum_j decay(last, j) B_j (x) xdt_j
    a_cum = torch.cumsum(a_hqt, dim=-1)                        # (b,nc,H,Q)
    decay_to_end = torch.exp(a_cum[..., -1:] - a_cum)
    S_c = torch.einsum("bchq,bcqhn,bcqhp->bchpn", decay_to_end, Bq, xdt)
    chunk_decay = torch.exp(a_cum[..., -1])                    # (b,nc,H)

    # inter-chunk recurrence: the reference's lax.scan, as a loop
    h = (torch.zeros((b, H, P, N), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c][..., None, None] + S_c[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                       # (b,nc,H,P,N)

    # inter-chunk outputs: y_off[i] = C_i exp(cum_a_i) h_{c-1}
    in_decay = torch.exp(a_cum)
    y_off = torch.einsum("bcqhn,bchpn,bchq->bcqhp", Cq, h_prev, in_decay)

    y = (y_diag + y_off).reshape(b, S, H, P)
    return y.to(x.dtype), h


def ssd_reference(x, dt, A, B, C):
    """Sequential oracle: h_t = h_{t-1} exp(A dt_t) + dt_t B_t (x) x_t,
    y_t = C_t . h_t."""
    b, S, H, P = x.shape
    G = B.shape[2]
    N = B.shape[3]
    rep = H // G
    f32 = torch.float32
    Bh = _repeat(B, rep, 2).to(f32)
    Ch = _repeat(C, rep, 2).to(f32)
    xdt = x.to(f32) * dt.to(f32)[..., None]
    decay = torch.exp(dt.to(f32) * A.to(f32)[None, None, :])   # (b,S,H)
    h = torch.zeros((b, H, P, N), dtype=f32, device=x.device)
    ys = []
    for t in range(S):
        h = h * decay[:, t][..., None, None] + torch.einsum(
            "bhn,bhp->bhpn", Bh[:, t], xdt[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s = cfg.ssm
    d_inner, nheads, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(zxbcdt, [d_inner, d_inner, gn, gn, nheads], dim=-1)


def _local(cfg: ModelConfig, plan) -> tuple[int, int, int]:
    """(tp, rank, d_inner / tp) of the SSM heads' split under ``plan``,
    (1, 0, d_inner) where it does not split them."""
    d_inner = _dims(cfg)[0]
    if plan is None or not plan.ssm_heads:
        return 1, 0, d_inner
    return plan.tp, plan.mesh.model_rank, d_inner // plan.tp


def mamba_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
                cache: Optional[dict] = None,
                backend: str = "einsum",
                plan=None) -> tuple[torch.Tensor, Optional[dict]]:
    """The full Mamba2 block.  ``cache`` = {"conv": (B, d_conv-1,
    conv_dim), "ssm": (B, H, P, N) fp32} selects the O(1) single-token
    step (S = 1), which writes both states in place and returns the same
    cache; without one the chunked path runs (S a multiple of the chunk,
    or below it).  Under a plan, ``params`` and ``cache`` are this rank's
    (module docstring) and the output is whole."""
    s = cfg.ssm
    bsz, S, _ = x.shape
    d_full = _dims(cfg)[0]
    tp, rank, d_inner = _local(cfg, plan)
    nheads = d_inner // s.head_dim
    gn = s.n_groups * s.d_state
    conv_dim = d_inner + 2 * gn
    P = s.head_dim

    zxbcdt = linear_apply(params["in_proj"], x, backend=backend)
    z, xc, B, C, dt = _split_proj(cfg, zxbcdt)
    if tp > 1:       # this rank's heads of the whole projection's parts
        z, xc, dt = (copy_to(t, plan.mesh.group) for t in (z, xc, dt))
        z, xc = (t[..., rank * d_inner:(rank + 1) * d_inner] for t in (z, xc))
        dt = dt[..., rank * nheads:(rank + 1) * nheads]
    xBC = torch.cat([xc, B, C], dim=-1)                        # (b,S,conv)
    w, cb = params["conv_w"], params["conv_b"]

    if cache is None:
        # causal depthwise conv through left padding: the reference's
        # einsum "bskc,kc->bsc" over the d_conv shifted windows
        pad = xBC.new_zeros((bsz, s.d_conv - 1, conv_dim))
        xpad = torch.cat([pad, xBC], dim=1)
        dtc = _promote(xBC, w)
        acc = None
        for i in range(s.d_conv):
            term = xpad[:, i:i + S].to(dtc) * w[i].to(dtc)
            acc = term if acc is None else acc + term
        xBC = F.silu(acc + cb)
    else:
        # the reference's window: its state in the model dtype at the
        # first step, in the window's own dtype after
        dtw = torch.promote_types(_model_dtype(cfg), xBC.dtype)
        window = torch.cat([cache["conv"].to(dtw), xBC.to(dtw)], dim=1)
        dtc = _promote(window, w)
        out = torch.einsum("bkc,kc->bc", window.to(dtc), w.to(dtc))
        xBC = F.silu(out + cb)[:, None, :]
        new_conv = window[:, 1:, :]

    xc2, B2, C2 = torch.split(xBC, [d_inner, gn, gn], dim=-1)
    if tp > 1:       # the whole B and C, read by this rank's heads
        B2, C2 = (copy_to(t, plan.mesh.group) for t in (B2, C2))
    xh = xc2.reshape(bsz, -1, nheads, P)
    Bh = B2.reshape(bsz, -1, s.n_groups, s.d_state)
    Ch = C2.reshape(bsz, -1, s.n_groups, s.d_state)
    dtv = softplus(dt.float() + params["dt_bias"])       # (b,S,H)
    A = -torch.exp(params["A_log"])

    if cache is None:
        y, _ = ssd_chunked(xh, dtv, A, Bh, Ch, chunk=s.chunk)
    else:
        f32 = torch.float32
        h = cache["ssm"].to(f32)                               # (b,H,P,N)
        rep = nheads // s.n_groups
        Bt = _repeat(Bh[:, 0], rep, 1).to(f32)
        Ct = _repeat(Ch[:, 0], rep, 1).to(f32)
        dt0 = dtv[:, 0].to(f32)                                # (b,H)
        dec = torch.exp(dt0 * A.to(f32)[None, :])
        h = h * dec[..., None, None] + torch.einsum(
            "bhn,bhp->bhpn", Bt, xh[:, 0].to(f32) * dt0[..., None])
        y = torch.einsum("bhn,bhpn->bhp", Ct, h)[:, None].to(x.dtype)
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(h)

    y = y + xh * params["D"][None, None, :, None]
    y = y.reshape(bsz, -1, d_inner)
    # gated RMSNorm (Mamba2): normalise in fp32, cast, then scale
    y = y * F.silu(z)
    yf = y.float()
    if tp > 1:       # the mean over the whole d_inner: the ranks' sums
        ss = reduce_both(torch.sum(torch.square(yf), dim=-1, keepdim=True),
                         plan.mesh.group)
        var = ss / d_full
    else:
        var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(var + 1e-6)).to(x.dtype)
    y = y * params["norm_scale"]
    out = linear_apply(params["out_proj"], y, backend=backend,
                       reduce=plan.mesh if tp > 1 else None)
    return out, cache


def mamba_cache_init(cfg: ModelConfig, batch: int, device=None,
                     plan=None) -> dict:
    """One layer's recurrent state, zeros: ``conv`` (batch, d_conv - 1,
    conv_dim) and ``ssm`` (batch, H, P, N), both fp32.  The reference
    takes the model dtype for ``conv``; here it is stored wide and read
    at its window's dtype (see the module docstring).  Under a plan that
    splits the SSM heads, this rank's: ``conv`` over its ``x`` channels
    and ``B``/``C`` whole, ``ssm`` over its ``H / tp`` heads."""
    s = cfg.ssm
    _, _, d_inner = _local(cfg, plan)
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim),
                            dtype=torch.float32, device=device),
        "ssm": torch.zeros((batch, nheads, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


__all__ = [
    "mamba_init",
    "mamba_apply",
    "mamba_cache_init",
    "ssd_chunked",
    "ssd_reference",
    "softplus",
]
