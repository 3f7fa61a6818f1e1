"""Carry parameters from the reference into the port.

``params_from_numpy`` takes the reference's params as a nested dict of
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``) and returns
the port's params: the same keys, the same layout (stacked leading layer
axis included) and the same dtypes, as tensors on ``device``.  It walks
any nested dict, so every family's tree crosses as it is: an
encoder-decoder's ``encoder`` / ``ln_enc`` and ``xattn``, a hybrid's
``groups`` / ``shared_attn`` / ``tail``, a Mamba layer's ``conv_w``,
``conv_b``, ``A_log``, ``D``, ``dt_bias`` and ``norm_scale``.  It needs no
JAX, so a checkpoint saved as numpy arrays loads on a machine without it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device


def _tensor(a) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # writable, owned by the tensor
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, device: DeviceLike = None):
    """Nested dict of numpy arrays -> the same nested dict of tensors."""
    dev = resolve_device(device)

    def go(node):
        if isinstance(node, dict):
            return {k: go(v) for k, v in node.items()}
        return _tensor(node).to(dev)

    return go(tree)


__all__ = ["params_from_numpy"]
