"""Fused two-stage Monarch product on Hopper (``csrc/monarch.cu``).

Replaces ``repro/kernels/monarch.py:monarch_fused`` (Pallas
``_monarch_kernel``): y = reshape(R-stage(P(L-stage(reshape(x))))) with the
intermediate kept on chip, fp32 accumulation, the intermediate rounded to
``x.dtype`` between the stages, and the output in ``x.dtype``; and
``monarch_fused_q`` (Pallas ``_monarch_q_kernel``), the same product over
int8 or nibble-packed int4 factors with one fp32 scale per diagonal block,
dequantized on chip.  The quantized kernel is the float kernel's template
with another factor reader: each factor value is widened as
``float(v) * scale`` (``core.quant.dequantize_factor``'s one multiply), so
it is bitwise ``monarch_fused`` on the dequantized factors, launches with
the same geometry, and reads 1 or 0.5 bytes per weight instead of 4.

The design splits the product by output block: output block i needs only
``L[:, i, :]``, ``R[i]`` and the token rows of x, so a thread block owns
one token tile, a group of q-blocks and one slab of their output rows, and
the grid is tiles x q-groups x slabs.  :func:`fused_geometry` sizes it: at
decode (T <= 16) one tile of all T tokens and one q-block a block, so a
launch has q blocks; at prefill 32-token tiles and up to
:data:`MAX_Q_GROUP` q-blocks a block, which cuts the x tile's re-reads
from L2 while the grid keeps :data:`PREFILL_MIN_BLOCKS`.  A slab is all s
rows of R[i] unless shared memory forces fewer.  Splitting the slabs
further to put a block on every SM was measured slower on the H100 (a
decode launch is bound by one block's chain of loads and barriers, and
each extra slab repeats stage 1: ``chip_smoke.py``'s ``monarch_geometry``
phase).  Each block streams the x tile and its rows of L through two
shared-memory buffers with ``cp.async``, then its rows of R.

Bound on an H100 SXM: the factors dominate the bytes at serving sizes
(gpt2-medium's three factor pairs are 0.26, 0.66 and 1.31 MB in fp32) and
the product is 2*T*(kqp + qsk) FLOPs, so it is bytes-bound below about
T = 40 tokens and operations-bound above it, against 3.35 TB/s and
67 TFLOP/s fp32 without tensor cores.  At decode the factor bytes take
well under a microsecond spread over the SMs, so a launch is bound by its
latency (a round of loads a chunk, then a few hundred FMAs a thread) and,
on the host, by this wrapper's own time, which is why its launch arguments
are cached; at prefill by fp32 FMAs, the shared-memory reads that feed
them and the x tile's re-reads from L2.  It uses
no tensor cores: the served factors are fp32 and the kernel is held to
fp32 2e-5 of its plain version and B4 bitwise to B1, which TF32 or bf16
products would break (see the source note and PERF.md).

``monarch_fused`` (``monarch_fused_q``) launches the kernel for a CUDA
tensor and uses the plain version ``monarch_fused_plain``
(``monarch_fused_q_plain``) only for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core.quant import dequantize_factor
from repro_torch.kernels import _build

# a thread block may opt into 227 KB of dynamic shared memory on Hopper
SMEM_BUDGET_BYTES = 232448
# the fit rule's token tile (fused_fits)
FIT_TILE_T = 4
# csrc/monarch.cu: threads a block, bytes after every staged row, and the
# most q-blocks one block owns
THREADS = 256
ROW_PAD = 16
MAX_Q_GROUP = 4
# token tiles: all of T up to DECODE_TILE_T tokens, else PREFILL_TILE_T
DECODE_TILE_T = 16
PREFILL_TILE_T = 32
# blocks a prefill launch keeps: each group of q-blocks re-reads the x tile
# from L2, so a launch takes the largest groups that still leave at most 4
# of an H100 SXM's 132 SMs idle in its first wave
PREFILL_MIN_BLOCKS = 128
# bytes of one staging buffer (x chunk + L chunk) at fp32 widths
CHUNK_BUDGET_BYTES = 73728


def fused_fits(L_shape, R_shape) -> bool:
    """Which Monarch shapes take the fused kernel (else the staged bdmm
    branch of ``ops.monarch_mm``): a ``FIT_TILE_T``-row token tile's fp32
    intermediate (k*q), one padded factor block and a tile of x fit a
    block's shared memory.  This was the first design's own fit; it is kept
    as the dispatch rule so the same shapes go fused and staged as before,
    although the split kernel could take far wider ones (ROADMAP.md).  The
    reference decides by another rule, its factors' bytes against a 10 MiB
    VMEM budget, and sends the 128-block shapes (a 16384-wide intermediate,
    staged here) to its fused kernel: a designed difference, pinned by
    tests/test_torch_bdmm.py; the outputs agree either way."""
    return _fits(tuple(L_shape), tuple(R_shape))


@functools.lru_cache(maxsize=None)
def _fits(L_shape, R_shape) -> bool:
    k, q, p = L_shape
    _, s, _ = R_shape
    t = FIT_TILE_T
    return 4 * (t * k * q + max(q * (p + 1), s * (k + 1)) + t * p) <= \
        SMEM_BUDGET_BYTES


class FusedGeometry(NamedTuple):
    """One launch of ``csrc/monarch.cu``: ``grid`` blocks of ``threads``;
    block b owns token tile ``b // (q // q_group * n_slabs)``, the
    ``q_group`` q-blocks from ``(b // n_slabs) % (q // q_group) * q_group``
    and slab ``b % n_slabs`` of ``slab`` output rows of each; stage 1 walks
    the k diagonal blocks ``chunk`` at a time; ``smem_bytes`` of dynamic
    shared memory."""
    tile_t: int
    q_group: int
    slab: int
    chunk: int
    n_tiles: int
    n_slabs: int
    grid: int
    threads: int
    smem_bytes: int


def _r16(n: int) -> int:
    return (n + 15) // 16 * 16


def _buf_bytes(p, tile_t, q_group, chunk, x_bytes, l_row) -> int:
    """One staging buffer: the x chunk (tile_t x chunk rows of p values)
    and the chunk's rows of L[j, i0:i0+q_group, :], every row padded by
    ROW_PAD."""
    return (_r16(tile_t * chunk * (p * x_bytes + ROW_PAD))
            + _r16(chunk * (q_group * l_row + ROW_PAD)))


def _smem_bytes(k, p, tile_t, q_group, slab, chunk, x_bytes, l_row,
                r_row) -> int:
    """csrc/monarch.cu:layout: one staging buffer (two with several
    chunks), the fp32 intermediate (q_group, tile_t, k + 1) and the
    q_group x slab padded rows of R."""
    n_buf = 1 if chunk == k else 2
    return (n_buf * _buf_bytes(p, tile_t, q_group, chunk, x_bytes, l_row)
            + _r16(q_group * tile_t * (k + 1) * 4)
            + _r16(q_group * slab * (r_row + ROW_PAD)))


def _row_bytes(n: int, w_bits: int) -> int:
    return n * w_bits // 8


def _chunk(k: int, p: int, tile_t: int, q_group: int) -> int:
    """Most diagonal blocks per stage-1 chunk (a divisor of k) whose
    staging buffer fits CHUNK_BUDGET_BYTES at fp32 widths; 0 if none."""
    fits = [jc for jc in range(1, k + 1) if k % jc == 0 and _buf_bytes(
        p, tile_t, q_group, jc, 4, 4 * p) <= CHUNK_BUDGET_BYTES]
    return max(fits, default=0)


@functools.lru_cache(maxsize=4096)
def _plan(L_shape, R_shape, T: int) -> Optional[tuple[int, int, int, int]]:
    """(tile_t, q_group, slab, chunk) for T tokens, sized at fp32 widths so
    that every dtype launches the same blocks and sums in the same order
    (the quantized kernel stays bitwise the float one); None if nothing
    fits."""
    k, q, p = L_shape
    s = R_shape[1]
    decode = T <= DECODE_TILE_T
    tile = T if decode else PREFILL_TILE_T
    while tile >= 1:
        n_tiles = -(-T // tile)
        for qg in range(MAX_Q_GROUP, 0, -1):
            if q % qg or (qg > 1 and (
                    decode or n_tiles * (q // qg) < PREFILL_MIN_BLOCKS)):
                continue
            chunk = _chunk(k, p, tile, qg)
            if not chunk:
                continue
            slab = s
            while True:
                need = _smem_bytes(k, p, tile, qg, slab, chunk, 4, 4 * p,
                                   4 * k)
                if need <= SMEM_BUDGET_BYTES or slab == 1:
                    break
                slab = -(-slab // 2)
            if need <= SMEM_BUDGET_BYTES:
                return tile, qg, slab, chunk
        tile //= 2
    return None


def fused_geometry(L_shape, R_shape, T: int, x_bytes: int = 4,
                   w_bits: int = 32,
                   slab: Optional[int] = None) -> Optional[FusedGeometry]:
    """The launch of the fused kernel for T >= 1 tokens of ``x_bytes``
    each and factors of ``w_bits`` a weight (32, 16, 8 or 4), or None when
    no geometry fits shared memory.  ``slab`` replaces the plan's rows of
    R[i] a block (to compare launches; the wrappers never pass it)."""
    if T < 1:
        raise ValueError(f"fused_geometry: T = {T}")
    k, q, p = (int(v) for v in L_shape)
    s = int(R_shape[1])
    plan = _plan((k, q, p), (q, s, k), int(T))
    if plan is None:
        return None
    tile, qg, planned, chunk = plan
    if slab is None:
        slab = planned
    elif not 1 <= slab <= s or _smem_bytes(
            k, p, tile, qg, slab, chunk, 4, 4 * p, 4 * k) > SMEM_BUDGET_BYTES:
        return None
    n_tiles, n_slabs = -(-T // tile), -(-s // slab)
    smem = _smem_bytes(k, p, tile, qg, slab, chunk, x_bytes,
                       _row_bytes(p, w_bits), _row_bytes(k, w_bits))
    return FusedGeometry(tile, qg, slab, chunk, n_tiles, n_slabs,
                         n_tiles * (q // qg) * n_slabs, THREADS, smem)


@functools.lru_cache(maxsize=4096)
def _launch_args(what: str, k, q, p, s, T, x_dtype, w,
                 slab: Optional[int] = None) -> ctypes.Array:
    """The C entry point's ``args`` for one launch (csrc/monarch.cu: Args):
    shape, geometry (``slab`` as in :func:`fused_geometry`), x's dtype
    code and ``w``, the factors' dtype (float kernel) or bits (quantized).
    Cached, and one array instead of 14 ints: at decode the wrapper's host
    time is as long as the launch.  Raises where no geometry fits or a
    dtype is not taken."""
    x_code = _build.dtype_code_of(x_dtype, f"{what} x")
    w_bits = w
    if isinstance(w, torch.dtype):
        w_bits = 8 * w.itemsize
        w = _build.dtype_code_of(w, f"{what} factors")
    g = fused_geometry((k, q, p), (q, s, k), T, x_dtype.itemsize, w_bits,
                       slab)
    if g is None:
        raise ValueError(f"{what}: factors ({k}, {q}, {p}) / ({q}, {s}, "
                         f"{k}) have no launch geometry at T = {T}")
    return (ctypes.c_int * 14)(T, k, q, p, s, g.tile_t, g.q_group, g.slab,
                               g.chunk, g.grid, g.threads, g.smem_bytes,
                               x_code, w)


def monarch_fused_plain(x: torch.Tensor, L: torch.Tensor,
                        R: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: fp32 products, the
    intermediate rounded to ``x.dtype``, the output in ``x.dtype``."""
    T, _ = x.shape
    k, q, p = L.shape
    _, s, _ = R.shape
    u = torch.einsum("tkp,kqp->tkq", x.float().reshape(T, k, p), L.float())
    u = u.to(x.dtype).float()
    y = torch.einsum("tqk,qsk->tqs", u.transpose(1, 2), R.float())
    return y.reshape(T, q * s).to(x.dtype)


_ARGTYPES = [ctypes.c_void_p] * 6


def monarch_fused(x: torch.Tensor, L: torch.Tensor,
                  R: torch.Tensor) -> torch.Tensor:
    """x: (T, din) -> (T, dout) with din = k*p, dout = q*s."""
    T, din = x.shape
    k, q, p = L.shape
    q2, s, k2 = R.shape
    if (q2, k2) != (q, k) or k * p != din:
        raise ValueError(f"bad shapes x{tuple(x.shape)} L{tuple(L.shape)} "
                         f"R{tuple(R.shape)}")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return monarch_fused_plain(x, L, R)
        raise ValueError("monarch_fused: x, L and R must share one CUDA "
                         "device")
    dev = x.get_device()
    if L.get_device() != dev or R.get_device() != dev:
        raise ValueError("monarch_fused: x, L and R must share one CUDA "
                         "device")
    if not (x.is_contiguous() and L.is_contiguous() and R.is_contiguous()):
        raise ValueError("monarch_fused: tensors must be contiguous")
    if L.dtype != R.dtype:
        raise TypeError("monarch_fused: L and R must share a dtype")
    if not fused_fits((k, q, p), (q, s, k)):
        raise ValueError(f"monarch_fused: factors L{tuple(L.shape)} "
                         f"R{tuple(R.shape)} take the staged branch")
    y = torch.empty((T, q * s), dtype=x.dtype, device=x.device)
    if T == 0:
        return y
    args = _launch_args("monarch_fused", k, q, p, s, T, x.dtype, L.dtype)
    lib = _build.library("monarch", "monarch_fused_launch", _ARGTYPES)
    err = lib.monarch_fused_launch(x.data_ptr(), L.data_ptr(), R.data_ptr(),
                                   y.data_ptr(), args, _build.stream_of(x))
    _build.check(err, "monarch_fused launch")
    _build.LAUNCHES["monarch_fused"] += 1
    return y


def quant_dims(x_shape, Lq, Ls, Rq, Rs) -> tuple[int, int, int, int, int]:
    """(k, q, p, s, bits) of a quantized factor pair for activations of
    ``x_shape``; bits 4 when both factors are packed along their
    contraction axis.  Raises on a container the kernels do not take."""
    return _quant_dims(x_shape[-1], Lq.shape, Ls.shape, Rq.shape, Rs.shape)


@functools.lru_cache(maxsize=None)
def _quant_dims(din, Lq_shape, Ls_shape, Rq_shape, Rs_shape):
    k, q = Ls_shape[0], Rs_shape[0]
    p, s = din // k, Rq_shape[1]
    ok = (k * p == din and len(Lq_shape) == 3 and len(Rq_shape) == 3
          and tuple(Lq_shape[:2]) == (k, q) and Rq_shape[0] == q
          and tuple(Ls_shape) == (k, 1, 1) and tuple(Rs_shape) == (q, 1, 1))
    if ok and (Lq_shape[2], Rq_shape[2]) == (p, k):
        return k, q, p, s, 8
    if ok and (2 * Lq_shape[2], 2 * Rq_shape[2]) == (p, k):
        return k, q, p, s, 4
    raise ValueError(f"bad quantized shapes x(..., {din}) "
                     f"Lq{tuple(Lq_shape)} Ls{tuple(Ls_shape)} "
                     f"Rq{tuple(Rq_shape)} Rs{tuple(Rs_shape)}")


def monarch_fused_q_plain(x: torch.Tensor, Lq: torch.Tensor,
                          Ls: torch.Tensor, Rq: torch.Tensor,
                          Rs: torch.Tensor) -> torch.Tensor:
    """The quantized kernel's arithmetic in plain PyTorch: dequantize both
    factors to fp32, then :func:`monarch_fused_plain`."""
    k, _, p, _, _ = quant_dims(x.shape, Lq, Ls, Rq, Rs)
    return monarch_fused_plain(x, dequantize_factor(Lq, Ls, unpacked_dim=p),
                               dequantize_factor(Rq, Rs, unpacked_dim=k))


_Q_ARGTYPES = [ctypes.c_void_p] * 8


def monarch_fused_q(x: torch.Tensor, Lq: torch.Tensor, Ls: torch.Tensor,
                    Rq: torch.Tensor, Rs: torch.Tensor) -> torch.Tensor:
    """x: (T, k*p) -> (T, q*s) in x's dtype; Lq: (k, q, p[/2]) int8, Ls:
    (k, 1, 1) fp32, Rq: (q, s, k[/2]) int8, Rs: (q, 1, 1) fp32."""
    T, _ = x.shape
    k, q, p, s, bits = quant_dims(x.shape, Lq, Ls, Rq, Rs)
    if not x.is_cuda:
        if x.device.type == "cpu":
            return monarch_fused_q_plain(x, Lq, Ls, Rq, Rs)
        raise ValueError("monarch_fused_q: every tensor must be on one CUDA "
                         "device")
    dev = x.get_device()
    if (Lq.get_device() != dev or Ls.get_device() != dev
            or Rq.get_device() != dev or Rs.get_device() != dev):
        raise ValueError("monarch_fused_q: every tensor must be on one CUDA "
                         "device")
    if not (x.is_contiguous() and Lq.is_contiguous() and Ls.is_contiguous()
            and Rq.is_contiguous() and Rs.is_contiguous()):
        raise ValueError("monarch_fused_q: tensors must be contiguous")
    if not (Lq.dtype is torch.int8 and Rq.dtype is torch.int8
            and Ls.dtype is torch.float32 and Rs.dtype is torch.float32):
        raise TypeError("monarch_fused_q: factors int8, scales float32")
    if not fused_fits((k, q, p), (q, s, k)):
        raise ValueError(f"monarch_fused_q: factors ({k}, {q}, {p}) / "
                         f"({q}, {s}, {k}) take the staged branch")
    y = torch.empty((T, q * s), dtype=x.dtype, device=x.device)
    if T == 0:
        return y
    args = _launch_args("monarch_fused_q", k, q, p, s, T, x.dtype, bits)
    lib = _build.library("monarch", "monarch_fused_q_launch", _Q_ARGTYPES)
    err = lib.monarch_fused_q_launch(
        x.data_ptr(), Lq.data_ptr(), Ls.data_ptr(), Rq.data_ptr(),
        Rs.data_ptr(), y.data_ptr(), args, _build.stream_of(x))
    _build.check(err, "monarch_fused_q launch")
    _build.LAUNCHES["monarch_fused_q"] += 1
    return y


__all__ = ["monarch_fused", "monarch_fused_plain", "monarch_fused_q",
           "monarch_fused_q_plain", "quant_dims", "fused_fits",
           "fused_geometry", "FusedGeometry", "SMEM_BUDGET_BYTES"]
