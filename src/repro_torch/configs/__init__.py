"""Architecture registry of the port: ``get_config(name)``.

Variants are selected with a suffix, as in ``repro.configs``:
``name`` -> Monarch-sparse (paper policy), ``name:dense`` -> dense
baseline, ``name:mxu`` -> Monarch with 128-aligned blocks.  Ported are
the architectures whose layers the port has (attention stacks: LayerNorm
or RMSNorm, GELU, SwiGLU or squared-ReLU FFNs, MHA or GQA, RoPE, tied or
untied embeddings); the others come with the model families they need.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.core.linear import MonarchSpec
from repro_torch.models.config import ModelConfig

PORTED_ARCHS = ["gpt2-medium", "bert-large-lm", "codeqwen1.5-7b",
                "minicpm-2b", "nemotron-4-15b"]


def _module_name(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(name: str) -> ModelConfig:
    if ":" in name:
        base, variant = name.split(":", 1)
    else:
        base, variant = name, "paper"
    base = base.replace(".", "_")
    if _module_name(base) not in {_module_name(a) for a in PORTED_ARCHS}:
        raise NotImplementedError(
            f"arch {base!r} is not ported yet (ported: {PORTED_ARCHS})")
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(base)}")
    cfg: ModelConfig = mod.CONFIG
    if variant == "dense":
        return dataclasses.replace(cfg, monarch=MonarchSpec(enable=False))
    if variant == "mxu":
        return dataclasses.replace(
            cfg, monarch=dataclasses.replace(cfg.monarch, enable=True,
                                             policy="mxu128"))
    if variant == "paper":
        return cfg
    raise ValueError(f"unknown variant {variant!r} for arch {base!r}")


__all__ = ["get_config", "PORTED_ARCHS"]
