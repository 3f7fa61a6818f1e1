"""Quickstart: the paper's pipeline end to end (port of
``examples/quickstart.py``).

1. Build a small dense transformer.
2. D2S-convert its parameterized matmuls to Monarch (rank-1 SVD, Sec III-A).
3. Map the factors onto CIM arrays under all three strategies and print the
   Fig-6-style utilization/array table + Fig-7-style latency/energy.
4. Run the Monarch model forward (einsum path and hand-written kernel path:
   B1, ``monarch_fused``, on the card; its plain version on the CPU).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.cim.dse import calibrated_config
from repro_torch.cim.simulator import simulate
from repro_torch.cim.workload import bert_large
from repro_torch.configs import get_config
from repro_torch.core.d2s import convert_tree
from repro_torch.core.linear import linear_apply
from repro_torch.models import transformer as T

# fp32 agreement of the kernel with the einsum path (tests/test_kernels.py)
FP32_TOL = 2e-5


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    print(f"== 1. small dense model (bert-large family, reduced) on {dev} ==")
    cfg = get_config("bert-large-lm:dense").reduced()
    params = T.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=gen, device=dev)
    logits_dense, _ = T.forward(params, {"tokens": tokens}, cfg, train=False)
    print("dense logits:", tuple(logits_dense.shape))

    print("\n== 2. D2S transformation (Sec. III-A) ==")
    def select(path, leaf):
        return any(s in path for s in ("wq", "wk", "wv", "wo", "w1", "w2", "wg"))
    sparse_params, reports = convert_tree(params, select)
    for r in reports[:4]:
        print(f"  {r.name:60s} {r.din}x{r.dout} -> {r.sparse_params} params "
              f"({r.compression:.1f}x), rel_err={r.rel_error:.3f}")
    print(f"  ... {len(reports)} matmuls converted")
    logits_sparse, _ = T.forward(sparse_params, {"tokens": tokens}, cfg,
                                 train=False)
    if not bool(torch.isfinite(logits_sparse).all()):
        raise SystemExit("quickstart FAILED: non-finite logits after D2S")

    print("\n== 3. CIM mapping + scheduling (Sec. III-B/C, full-size model) ==")
    cimcfg = calibrated_config()
    m = bert_large()
    for strat in ("linear", "sparse", "dense"):
        r = simulate(m, strat, cimcfg)
        print(f"  {strat:7s} arrays={r.n_arrays:5d} util={r.utilization:6.1%} "
              f"lat/token={r.latency_ns_per_token:9.0f}ns "
              f"energy/token={r.energy_nj_per_token:9.0f}nJ")

    print("\n== 4. Monarch forward: einsum vs the hand-written kernel ==")
    mcfg = get_config("bert-large-lm").reduced()
    mparams = T.init_params(mcfg, seed=0, device=dev)
    attn = mparams["decoder"]["layers"]["attn"]["wq"]
    L = attn["L"][0]  # layer 0 slice of the stacked factors
    R = attn["R"][0]
    x = torch.randn((4, L.shape[0] * L.shape[2]), generator=gen, device=dev)
    y_einsum = linear_apply({"L": L, "R": R}, x, backend="einsum")
    y_kernel = linear_apply({"L": L, "R": R}, x, backend="pallas")
    err = float((y_einsum - y_kernel).abs().max())
    print("  max |einsum - kernel| =", err)
    if not err <= FP32_TOL:
        raise SystemExit(f"quickstart FAILED: kernel differs by {err}")
    print("\nquickstart OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
