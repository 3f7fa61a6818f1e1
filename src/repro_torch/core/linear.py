"""Unified linear layer: dense or Monarch, selected per matmul by config
(port of ``repro.core.linear``).

``MonarchSpec.backend`` keeps the reference's values so a config means the
same in both packages: ``"einsum"`` is the plain PyTorch product, and
``"pallas"`` selects the hand-written kernel (``kernels.ops.monarch_mm``).

dtype flow mirrors the reference per backend, because ``torch.matmul``
refuses mixed dtypes where ``jnp.einsum`` promotes:

  * einsum and dense: computed in the promotion of x and the weights (bf16
    x with fp32 factors returns fp32, as ``jnp.einsum`` does);
  * kernel: returns ``x.dtype`` (the Pallas kernel's ``out_shape``).

A quantized container (``core.quant``: int8/int4 ``Lq``/``Rq`` with
per-block ``Ls``/``Rs``) takes ``kernels.ops.monarch_mm_q`` on the kernel
backend, and on the einsum backend is dequantized to fp32 factors first, so
it then follows the einsum row above.

Tensor parallelism follows the Megatron pairs of ``sharding.params``: a
column-parallel linear is a smaller linear of the same kind and needs
nothing here; a row-parallel one passes ``reduce=`` its mesh and ends in
an all-reduce.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.core import monarch as mn
from repro_torch.core import quant as qn
from repro_torch.sharding.api import all_reduce_sum


@dataclasses.dataclass(frozen=True)
class MonarchSpec:
    """How to Monarch-factorize the parameterized matmuls of a model."""

    enable: bool = False
    policy: str = "paper"          # "paper" (b ~ sqrt(n)) | "mxu128"
    nblocks: Optional[int] = None  # explicit override
    backend: str = "einsum"        # "einsum" | "pallas" (hand-written kernel)
    min_dim: int = 256             # don't factorize tiny matmuls (routers)

    def applies(self, din: int, dout: int) -> bool:
        return self.enable and min(din, dout) >= self.min_dim


def linear_init(
    gen: torch.Generator,
    din: int,
    dout: int,
    spec: Optional[MonarchSpec] = None,
    use_bias: bool = False,
    dtype: torch.dtype = torch.float32,
    w_init_scale: float = 1.0,
    device: Optional[torch.device] = None,
) -> dict[str, torch.Tensor]:
    """Initialize a linear layer; Monarch-factorized when spec.applies()."""
    dev = device if device is not None else gen.device
    if spec is not None and spec.applies(din, dout):
        dims = mn.make_dims(din, dout, policy=spec.policy,
                            nblocks=spec.nblocks)
        params = mn.init_monarch(gen, dims, dtype=dtype, scale=w_init_scale,
                                 device=dev)
    else:
        std = w_init_scale * (1.0 / math.sqrt(din))
        w = torch.randn((din, dout), generator=gen, device=dev) * std
        params = {"w": w.to(dtype)}
    if use_bias:
        params["b"] = torch.zeros((dout,), dtype=dtype, device=dev)
    return params


def is_monarch(params: dict[str, Any]) -> bool:
    return "L" in params and "R" in params


def linear_apply(params: dict[str, Any], x: torch.Tensor,
                 backend: str = "einsum", reduce=None) -> torch.Tensor:
    """y = x @ W (+ b).  Dispatches on the parameter structure (including
    D2S-converted dense layers, where ``w`` becomes an {L, R} dict).

    Under tensor parallelism ``params`` are this rank's slices
    (``sharding.params.shard_params``).  A row-parallel linear passes
    ``reduce``, its mesh: ``x`` is then this rank's input columns, the
    product a partial ``y``, summed over the mesh's ranks by one
    all-reduce before the (whole) bias is added once."""
    if "w" in params and isinstance(params["w"], dict):
        inner = dict(params["w"])
        if "b" in params:
            inner["b"] = params["b"]
        return linear_apply(inner, x, backend=backend, reduce=reduce)
    if qn.is_quantized(params) and reduce is not None:
        raise NotImplementedError(
            "quantized factors under tensor parallelism are not ported yet")
    if qn.is_quantized(params):
        if backend == "pallas":
            from repro_torch.kernels import ops as kops  # lazy: avoid cycle

            y = kops.monarch_mm_q(x, params["Lq"], params["Ls"],
                                  params["Rq"], params["Rs"])
        else:
            k = params["Ls"].shape[-3]
            deq = qn.dequantize_monarch(params, k, x.shape[-1] // k)
            y = mn.monarch_multiply(x, deq["L"], deq["R"])
    elif is_monarch(params):
        if backend == "pallas":
            from repro_torch.kernels import ops as kops  # lazy: avoid cycle

            y = kops.monarch_mm(x, params["L"], params["R"])
        else:
            y = mn.monarch_multiply(x, params["L"], params["R"])
    else:
        w = params["w"]
        dt = torch.promote_types(x.dtype, w.dtype)
        y = torch.matmul(x.to(dt), w.to(dt))
    if reduce is not None:
        y = all_reduce_sum(y, reduce)
    if "b" in params:
        y = y + params["b"]
    return y


def is_quantized(params: dict[str, Any]) -> bool:
    """Quantized Monarch container (core.quant): int8/int4 factors +
    per-block scales."""
    return qn.is_quantized(params)


def linear_out_dim(params: dict[str, Any]) -> int:
    if isinstance(params.get("w"), dict):   # D2S-nested factors
        return linear_out_dim(params["w"])
    if qn.is_quantized(params):
        return qn.quantized_out_dim(params)
    if is_monarch(params):
        q, s, _ = params["R"].shape
        return q * s
    return params["w"].shape[1]


__all__ = [
    "MonarchSpec",
    "linear_init",
    "linear_apply",
    "is_monarch",
    "is_quantized",
    "linear_out_dim",
]
