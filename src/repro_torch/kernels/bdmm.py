"""One block-diagonal Monarch stage on Hopper (``csrc/bdmm.cu``).

Replaces ``repro/kernels/bdmm.py:bdmm`` (Pallas ``_bdmm_kernel``):
out[t, j, :] = x[t, j, :] @ W[j].T with fp32 accumulation and the output in
``x.dtype``; and ``bdmm_q`` (Pallas ``_bdmm_q_kernel``), the same stage over
int8 or nibble-packed int4 blocks with one fp32 scale per block, each weight
widened as ``float(v) * scale`` where it is read (one multiply, as
``core.quant.dequantize_factor``), so it is bitwise ``bdmm`` on the
dequantized blocks.  They are the staged branch of ``ops.monarch_mm`` /
``ops.monarch_mm_q``, taken where ``monarch.fused_fits`` refuses the fused
kernel; stage 2 reads the stage-1 output through a transposed view, so its
reduction axis has stride q and only the block axis is contiguous.

:func:`bdmm_geometry` picks and sizes one of two instances from the shapes:

- **decode** (T <= :data:`DECODE_MAX_T`): bound by the weight bytes (each
  weight feeds T products) and, for small blocks, by a launch's latency.
  Each weight is read once, straight into registers, a 4-value unit a
  load; only x is staged.  A block owns a group of diagonal blocks and a
  slab of their rows, one pass: each row a group of ``lanes`` lanes with
  about :data:`UNITS_PER_LANE` units each, more lanes where a block's rows
  would otherwise span diagonal blocks (up to 32 for 8-row blocks), and
  several diagonal blocks a block only where even 32 lanes a row leave
  lane groups idle.
- **prefill** (larger T): bound by operations.  mma.sync TF32 tensor cores
  with each fp32 operand split into two TF32 halves (3 products, 2 for a bf16
  x, fp32 accumulate), so the result holds fp32 2e-5 of the plain version.
  A block owns a token tile, a group of diagonal blocks and a slab of rows,
  walks p in chunks of :data:`PREFILL_KC` and never stages a block whole, so
  any block size fits.  The tile is chosen by a traffic model
  (:func:`_prefill_cost`): W is re-read once per token tile and x once per
  slab, and the stride-q x of stage 2 costs a 32-byte sector a value unless
  the group's blocks share it, so stage 2 takes 8 diagonal blocks a tile.

Neither instance splits p across blocks or uses atomics: a launch is
deterministic.  Bound on an H100 SXM: bytes (x, W and the output once each)
over 3.35 TB/s, or 2*T*k*q*p FLOPs over the rate of the arithmetic that does
them (decode: 67 TFLOP/s fp32 FMA; prefill: 495 TFLOP/s TF32 over the 3 or 2
products), whichever is larger.

``bdmm`` (``bdmm_q``) launches the kernel for a CUDA tensor and uses the
plain version ``bdmm_plain`` (``bdmm_q_plain``) only for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core.quant import dequantize_factor
from repro_torch.kernels import _build
from repro_torch.kernels.monarch import SMEM_BUDGET_BYTES

# csrc/bdmm.cu: threads and warps a block
THREADS = 256
WARPS = THREADS // 32
# the decode instance takes up to DECODE_MAX_T tokens (csrc/bdmm.cu: TMAX)
DECODE_MAX_T = 16
# decode: units (4 values) a lane aims to own in a row
UNITS_PER_LANE = 4
# prefill: p values a chunk (csrc/bdmm.cu: KC) and the bytes after every
# staged row (PAD)
PREFILL_KC = 16
PREFILL_PAD = 16
# prefill: chunks in flight (csrc/bdmm.cu: NSTAGE)
PREFILL_STAGES = 3
# prefill traffic model, to rank tiles (not a measurement): multiply-adds a
# second of one TF32 mma pass and bytes a second from L2, on an H100 SXM
MMA_MACS_PER_S = 8e13
L2_BYTES_PER_S = 6e12
SECTOR_BYTES = 32


class BdmmGeometry(NamedTuple):
    """One launch of ``csrc/bdmm.cu``: ``grid`` blocks of ``threads``;
    block b owns token tile ``b // (n_groups * n_slabs)`` of ``tile_t``
    tokens, diagonal blocks ``(b // n_slabs) % n_groups * group`` onward
    (``group`` of them) and rows ``b % n_slabs * slab`` onward (``slab``)
    of each; the ragged ends are masked.  ``instance`` "decode": ``lanes``
    lanes share a row's dot product, each loading ``unit`` values at once;
    "prefill": warps laid out group x ``warps_m`` x ``warps_n``, each with
    32 tokens x ``n_frag`` 8-row mma tiles.  ``smem_bytes`` of dynamic
    shared memory."""
    instance: str
    tile_t: int
    group: int
    slab: int
    lanes: int
    unit: int
    warps_m: int
    warps_n: int
    n_frag: int
    n_tiles: int
    n_groups: int
    n_slabs: int
    grid: int
    threads: int
    smem_bytes: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_floor(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def _pow2_ceil(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def _decode_smem(T: int, p: int, group: int) -> int:
    """csrc/bdmm.cu: bdmm_decode_kernel's x slice, fp32 (group, T, p)
    with rows padded to 4 values."""
    return 4 * group * T * ((p + 3) // 4 * 4)


def _r16(n: int) -> int:
    return (n + 15) // 16 * 16


def _prefill_smem(group: int, tile_t: int, slab: int, p: int, x_bytes: int,
                  w_bits: int) -> int:
    """csrc/bdmm.cu:playout: a buffer holds one chunk, its x rows (group x
    tile_t) and W rows (group x slab) of PREFILL_KC raw values each plus
    PREFILL_PAD bytes; a ring of PREFILL_STAGES buffers, fewer where p
    takes fewer chunks; at least the output tile, rows (group x tile_t) of
    slab values in x's type plus PREFILL_PAD bytes."""
    buf = (_r16(group * tile_t * (PREFILL_KC * x_bytes + PREFILL_PAD))
           + _r16(group * slab * (PREFILL_KC * w_bits // 8 + PREFILL_PAD)))
    ring = min(PREFILL_STAGES, _cdiv(p, PREFILL_KC)) * buf
    return max(ring, _r16(group * tile_t * (slab * x_bytes + PREFILL_PAD)))


def _decode(T, k, q, p, lanes: Optional[int]) -> Optional[BdmmGeometry]:
    """One pass of rows a block: each row a group of ``lanes`` lanes with
    about UNITS_PER_LANE units each, as many lanes as put the block's rows
    in one diagonal block (a 256 / q ceiling), and several diagonal blocks
    a block only where their rows are fewer than its lane groups."""
    unit = 4 if p % 4 == 0 else 1
    nu = p // unit
    if lanes is None:
        lanes = min(32, _pow2_floor(nu),
                    max(_pow2_floor(nu // UNITS_PER_LANE),
                        _pow2_ceil(_cdiv(THREADS, q))))
    rows = THREADS // lanes  # rows of one pass
    if rows >= q:
        slab, group = q, min(k, rows // q)
    else:
        n_slabs = _cdiv(q, rows)
        slab = min(rows, _cdiv(_cdiv(q, n_slabs), 32 // lanes)
                   * (32 // lanes))
        group = 1
    while group > 1 and _decode_smem(T, p, group) > SMEM_BUDGET_BYTES:
        group -= 1
    smem = _decode_smem(T, p, group)
    if smem > SMEM_BUDGET_BYTES:
        return None
    n_groups, n_slabs = _cdiv(k, group), _cdiv(q, slab)
    return BdmmGeometry("decode", T, group, slab, lanes, unit, 0, 0, 0, 1,
                        n_groups, n_slabs, n_groups * n_slabs, THREADS,
                        smem)


def _prefill_cost(T, k, q, p, tile_t, group, slab, x_bytes,
                  x_contiguous) -> tuple[float, float]:
    """(modelled seconds, L2 bytes) of one prefill launch: the padded
    multiply-adds at the mma rate over the passes (3 for an fp32 x, 2 for
    bf16), or W re-read once per token tile and x once per slab from L2,
    whichever is longer.  A strided x (stage 2) moves a 32-byte sector per
    value, shared by the group's consecutive blocks."""
    n_tiles, n_groups, n_slabs = (_cdiv(T, tile_t), _cdiv(k, group),
                                  _cdiv(q, slab))
    macs = (n_tiles * tile_t * n_groups * group * n_slabs * slab
            * _cdiv(p, PREFILL_KC) * PREFILL_KC)
    passes = 3 if x_bytes == 4 else 2
    x_value = x_bytes if x_contiguous else max(x_bytes,
                                                SECTOR_BYTES / group)
    traffic = (n_groups * group * n_slabs * slab * p * 4 * n_tiles
               + T * k * p * x_value * n_slabs)
    return (max(macs * passes / MMA_MACS_PER_S, traffic / L2_BYTES_PER_S),
            traffic)


def _prefill(T, k, q, p, x_bytes, w_bits, x_contiguous,
             group: Optional[int]) -> BdmmGeometry:
    best = None
    for n_frag in (4, 2, 1):
        for warps_n in (1, 2, 4, 8):
            for g in (1, 2, 4, 8):
                if WARPS % (warps_n * g) or (group and g != group):
                    continue
                warps_m = WARPS // (warps_n * g)
                tile_t, slab = 32 * warps_m, 8 * n_frag * warps_n
                cost, traffic = _prefill_cost(T, k, q, p, tile_t, g, slab,
                                              x_bytes, x_contiguous)
                key = (cost, traffic, -n_frag, g, -slab)
                if best is None or key < best[0]:
                    best = (key, (tile_t, g, slab, warps_m, warps_n, n_frag))
    tile_t, g, slab, warps_m, warps_n, n_frag = best[1]
    n_tiles, n_groups, n_slabs = _cdiv(T, tile_t), _cdiv(k, g), _cdiv(q, slab)
    return BdmmGeometry("prefill", tile_t, g, slab, 0, 0, warps_m, warps_n,
                        n_frag, n_tiles, n_groups, n_slabs,
                        n_tiles * n_groups * n_slabs, THREADS,
                        _prefill_smem(g, tile_t, slab, p, x_bytes, w_bits))


@functools.lru_cache(maxsize=4096)
def bdmm_geometry(T: int, k: int, q: int, p: int, x_bytes: int = 4,
                  w_bits: int = 32, x_contiguous: bool = True, *,
                  instance: Optional[str] = None,
                  lanes: Optional[int] = None,
                  group: Optional[int] = None) -> BdmmGeometry:
    """The launch for T >= 1 tokens of x (T, k, p) with ``x_bytes`` a
    value against blocks (k, q, p) of ``w_bits`` a weight; ``x_contiguous``
    says x's p axis has stride 1 (stage 1; stage 2's transposed input does
    not).  The decode instance up to :data:`DECODE_MAX_T` tokens where its
    x slice fits shared memory, else prefill.  The weights' width never
    enters the choice, so the quantized kernel launches the float kernel's
    blocks and sums in its order.  ``instance``, ``lanes`` (decode: a power
    of two up to 32) and ``group`` (prefill: 1, 2, 4 or 8) override the
    plan, to compare launches; the wrappers never pass them."""
    if T < 1 or min(k, q, p) < 1:
        raise ValueError(f"bdmm_geometry: T = {T}, blocks ({k}, {q}, {p})")
    if w_bits not in (32, 16, 8, 4):
        raise ValueError(f"bdmm_geometry: {w_bits}-bit weights")
    if instance not in (None, "decode", "prefill"):
        raise ValueError(f"bdmm_geometry: instance {instance!r}")
    if instance != "prefill" and T <= DECODE_MAX_T:
        geo = _decode(T, k, q, p, lanes)
        if geo is not None:
            return geo
    if instance == "decode":
        raise ValueError(f"bdmm_geometry: no decode launch for T = {T}, "
                         f"blocks ({k}, {q}, {p})")
    return _prefill(T, k, q, p, x_bytes, w_bits, x_contiguous, group)


def bdmm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: fp32 products, output in
    ``x.dtype``."""
    return torch.einsum("tkp,kqp->tkq", x.float(), w.float()).to(x.dtype)


@functools.lru_cache(maxsize=4096)
def _launch_args(what: str, T: int, k: int, q: int, p: int, x_dtype,
                 w, x_contiguous: bool = True, **override) -> ctypes.Array:
    """The C entry point's ``args`` for one launch (csrc/bdmm.cu: Args):
    shape, geometry (``override`` as in :func:`bdmm_geometry`), x's dtype
    code and ``w``, the weights' dtype (float kernel) or bits (quantized).
    Cached, and one array instead of 18 ints: at decode the wrapper's host
    time is as long as the launch."""
    x_code = _build.dtype_code_of(x_dtype, f"{what} x")
    w_bits = w
    if isinstance(w, torch.dtype):
        w_bits = 8 * w.itemsize
        w = _build.dtype_code_of(w, f"{what} weights")
    g = bdmm_geometry(T, k, q, p, x_dtype.itemsize, w_bits, x_contiguous,
                      **override)
    return (ctypes.c_int * 18)(
        T, k, q, p, 0 if g.instance == "decode" else 1, g.tile_t, g.group,
        g.slab, g.lanes, g.unit, g.warps_m, g.warps_n, g.n_frag, g.grid,
        g.threads, g.smem_bytes, x_code, w)


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
             + [ctypes.c_void_p])
_Q_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
               + [ctypes.c_void_p])


def _launch(what: str, x: torch.Tensor, w: torch.Tensor,
            scale: Optional[torch.Tensor], w_code, q: int,
            **override) -> torch.Tensor:
    """Launch the float (``scale`` None) or quantized kernel on x, whose
    shapes and devices the caller has checked; ``override`` as in
    :func:`bdmm_geometry` (to compare launches; the wrappers pass none)."""
    T, k, p = x.shape
    out = torch.empty((T, k, q), dtype=x.dtype, device=x.device)
    if T == 0:
        return out
    sx = x.stride()
    args = _launch_args(what, T, k, q, p, x.dtype, w_code, sx[2] == 1,
                        **override)
    if scale is None:
        lib = _build.library("bdmm", "bdmm_launch", _ARGTYPES)
        err = lib.bdmm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                              args, sx[0], sx[1], sx[2], _build.stream_of(x))
    else:
        lib = _build.library("bdmm", "bdmm_q_launch", _Q_ARGTYPES)
        err = lib.bdmm_q_launch(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                                out.data_ptr(), args, sx[0], sx[1], sx[2],
                                _build.stream_of(x))
    _build.check(err, f"{what} launch")
    return out


def bdmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (T, k, p) (any strides), w: (k, q, p) -> (T, k, q)."""
    T, k, p = x.shape
    k2, q, p2 = w.shape
    if (k2, p2) != (k, p):
        raise ValueError(f"bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    if x.device.type == "cpu":
        return bdmm_plain(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError("bdmm: x and w must share one CUDA device")
    if not w.is_contiguous():
        raise ValueError("bdmm: w must be contiguous")
    out = _launch("bdmm", x, w, None, w.dtype, q)
    if T:
        _build.LAUNCHES["bdmm"] += 1
    return out


def _q_bits(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> int:
    _, k, p = x.shape
    ok = (wq.dim() == 3 and wq.shape[0] == k
          and tuple(scale.shape) == (k, 1, 1))
    if ok and wq.shape[2] == p:
        return 8
    if ok and 2 * wq.shape[2] == p:
        return 4
    raise ValueError(f"bad quantized shapes x{tuple(x.shape)} "
                     f"wq{tuple(wq.shape)} scale{tuple(scale.shape)}")


def bdmm_q_plain(x: torch.Tensor, wq: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """The quantized kernel's arithmetic in plain PyTorch: dequantize the
    blocks to fp32, then :func:`bdmm_plain`."""
    _q_bits(x, wq, scale)
    return bdmm_plain(x, dequantize_factor(wq, scale,
                                           unpacked_dim=x.shape[-1]))


def bdmm_q(x: torch.Tensor, wq: torch.Tensor,
           scale: torch.Tensor) -> torch.Tensor:
    """x: (T, k, p) (any strides), wq: (k, q, p) int8 or (k, q, p/2)
    nibble-packed int4, scale: (k, 1, 1) fp32 -> (T, k, q) in x's dtype."""
    T = x.shape[0]
    bits = _q_bits(x, wq, scale)
    q = wq.shape[1]
    if x.device.type == "cpu":
        return bdmm_q_plain(x, wq, scale)
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in (wq, scale)):
        raise ValueError("bdmm_q: x, wq and scale must share one CUDA "
                         "device")
    if not (wq.is_contiguous() and scale.is_contiguous()):
        raise ValueError("bdmm_q: wq and scale must be contiguous")
    if (wq.dtype, scale.dtype) != (torch.int8, torch.float32):
        raise TypeError("bdmm_q: wq int8, scale float32")
    out = _launch("bdmm_q", x, wq, scale, bits, q)
    if T:
        _build.LAUNCHES["bdmm_q"] += 1
    return out


__all__ = ["bdmm", "bdmm_plain", "bdmm_q", "bdmm_q_plain", "bdmm_geometry",
           "BdmmGeometry", "DECODE_MAX_T"]
