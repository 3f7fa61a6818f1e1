"""D2S conversion example (paper Fig. 2a flow): dense checkpoint -> Monarch
(port of ``examples/d2s_convert.py``).

Initializes a dense model, projects every parameterized matmul onto Monarch
factors (Sec. III-A), reports per-layer error/compression, and compares the
two models' outputs on the same input.

Run:  PYTHONPATH=src python -m repro_torch.examples.d2s_convert \\
          [--arch bert-large-lm] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.d2s import convert_tree
from repro_torch.models import transformer as T

MATMULS = ("wq", "wk", "wv", "wo", "w1", "w2", "wg", "in_proj", "out_proj")


def select(path: str, leaf) -> bool:
    return any(s in path for s in MATMULS)


def convert_and_compare(params: dict, cfg, tokens: torch.Tensor) -> dict:
    """D2S of ``params``' parameterized matmuls and the dense vs converted
    outputs on ``tokens``: {"n_converted", "dense_params",
    "sparse_params", "worst_rel_error", "worst_name", "tv"} (the mean
    total-variation distance of the two models' next-token
    distributions)."""
    sparse, reports = convert_tree(params, select)
    worst = max(reports, key=lambda r: r.rel_error)
    ld, _ = T.forward(params, {"tokens": tokens}, cfg, train=False)
    # the converted tree keeps Monarch leaves; forward dispatches on them
    ls, _ = T.forward(sparse, {"tokens": tokens}, cfg, train=False)
    pd, ps = torch.softmax(ld, -1), torch.softmax(ls, -1)
    tv = float(0.5 * torch.mean(torch.sum(torch.abs(pd - ps), dim=-1)))
    return {"n_converted": len(reports),
            "dense_params": sum(r.dense_params for r in reports),
            "sparse_params": sum(r.sparse_params for r in reports),
            "worst_rel_error": worst.rel_error, "worst_name": worst.name,
            "tv": tv}


def report_lines(fig: dict) -> list[str]:
    """The reference's four printed figures, then its last line."""
    d, s = fig["dense_params"], fig["sparse_params"]
    return [
        f"converted {fig['n_converted']} parameterized matmuls "
        f"(Para-Matmul only; embeddings/norms/routers untouched)",
        f"matmul params: {d/1e6:.2f}M -> {s/1e6:.2f}M "
        f"({d/max(s,1):.1f}x)",
        f"worst per-layer rel error: {fig['worst_rel_error']:.3f} "
        f"({fig['worst_name']})",
        f"mean total-variation distance dense vs D2S outputs: "
        f"{fig['tv']:.3f} (random init — trained checkpoints approximate "
        f"much better)",
        "d2s_convert OK",
    ]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="bert-large-lm")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(f"{args.arch}:dense").reduced()
    params = T.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=gen, device=dev)
    for line in report_lines(convert_and_compare(params, cfg, tokens)):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
