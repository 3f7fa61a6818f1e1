"""PyTorch/CUDA port of ``repro``: Monarch-sparse transformers served and
trained on an NVIDIA Hopper GPU.

The package mirrors ``repro``'s module layout and public names, so each
function has an obvious counterpart, but it imports neither JAX nor any
module of ``repro``.  Every Pallas kernel the reference runs on its serving
path has a hand-written CUDA C++ counterpart under ``kernels/csrc/`` with a
plain PyTorch version beside it (``kernels/monarch.py``, ``kernels/bdmm.py``,
``kernels/paged.py``).

Entry points (``init_params``, ``params_from_numpy``, ``init_paged_pool``,
``ContinuousBatchingEngine``, the train state of
``launch.steps.make_train_step`` and ``train.Trainer``) run on ``cuda``
unless the caller passes ``device="cpu"``; without a GPU and without that
explicit request they raise instead of silently dropping to the CPU.
Training runs the kernels' einsum counterparts: the hand-written kernels
have no backward pass and refuse autograd.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU only
    when asked for by name (``meta``, shapes alone, when asked for so).
    Raises when CUDA is wanted but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every tensor leaf of a nested dict, with the
    matching leaves of ``rest`` (nested dicts of the same keys) as its
    further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_to(tree, device: DeviceLike = None):
    """Copy a nested dict of tensors to ``device`` (resolved as above)."""
    dev = resolve_device(device)
    return tree_map(lambda a: a.to(dev), tree)


__all__ = ["resolve_device", "tree_map", "tree_to", "DeviceLike"]
