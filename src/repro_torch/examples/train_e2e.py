"""End-to-end training example (port of ``examples/train_e2e.py``): a
Monarch LM trained on the synthetic corpus.

Presets:
  --preset 100m   ~100M-param Monarch model, a few hundred steps
  --preset 20m    ~20M params, quick
  --preset tiny   smoke: seconds

Runs the whole substrate: data pipeline -> microbatched train step -> WSD
schedule -> checkpoint/resume -> heartbeat and straggler monitoring.  The
Monarch projections run on the einsum backend, as the reference trains
(the hand-written kernels have no backward pass and refuse autograd).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_e2e \\
          --preset tiny --steps 5 [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.core.linear import MonarchSpec
from repro_torch.data import DataConfig, make_batches
from repro_torch.models.config import ModelConfig
from repro_torch.train import Trainer, TrainerConfig

PRESETS = {
    "100m": dict(d_model=768, n_layers=12, n_heads=12, n_kv_heads=12,
                 d_ff=3072, vocab=32768, batch=8, seq=512),
    "20m": dict(d_model=384, n_layers=6, n_heads=6, n_kv_heads=6,
                d_ff=1536, vocab=8192, batch=8, seq=256),
    "tiny": dict(d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                 d_ff=256, vocab=512, batch=4, seq=64),
}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="tiny", choices=PRESETS)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--monarch", action="store_true", default=True)
    ap.add_argument("--dense", dest="monarch", action="store_false")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    p = PRESETS[args.preset]
    cfg = ModelConfig(
        name=f"e2e-{args.preset}",
        d_model=p["d_model"], n_layers=p["n_layers"], n_heads=p["n_heads"],
        n_kv_heads=p["n_kv_heads"], d_ff=p["d_ff"], vocab=p["vocab"],
        dtype="float32",
        monarch=MonarchSpec(enable=args.monarch, min_dim=128),
    )
    n = cfg.param_count()
    print(f"model: {cfg.name} params={n/1e6:.1f}M monarch={args.monarch}")

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=p["seq"],
                      global_batch=p["batch"])
    tcfg = TrainerConfig(
        steps=args.steps, peak_lr=3e-3, warmup=max(args.steps // 20, 2),
        schedule="wsd", accum_steps=args.accum,
        compress_grads=args.compress_grads, log_every=10,
        ckpt_every=max(args.steps // 3, 10), ckpt_dir=args.ckpt_dir)
    trainer = Trainer(cfg, tcfg, device=args.device)
    trainer.run(make_batches(dcfg))
    first = sum(h["loss"] for h in trainer.history[:5]) / 5
    last = sum(h["loss"] for h in trainer.history[-5:]) / 5
    print(f"loss: first5={first:.4f} last5={last:.4f} "
          f"({'DOWN' if last < first else 'no improvement'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
