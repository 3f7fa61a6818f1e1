#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    PYTHONPATH=src python3 chip_smoke.py

Phases, each printed as one JSON object per line:

  1. build    compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
  2. kernels  each kernel against its plain PyTorch version at the serving
              path's shapes, with its time, the plain version's time, one
              PyTorch library call's time and the card's bound
  3. serve    gpt2-medium at full width (24 layers, published bf16 dtype,
              seeded random weights) served by the continuous-batching
              engine through the Monarch and paged-attention kernels; then
              the same path with 128 Monarch blocks, whose intermediate is
              too wide for the fused kernel, through the staged bdmm branch
  4. parity   the same fp32 weights on the card and on the CPU (plain
              versions): one mixed step's logits, then greedy tokens of
              three engine traces (plain; a tiny pool that preempts;
              shared prefixes that fork pages copy-on-write)

It exits non-zero on the first failed check.  The last lines are the
per-kernel summary, the card's name and power limit from ``nvidia-smi``,
and ``{"ok": true, "device": {...}}``.  It needs one CUDA device and never
imports JAX or the reference package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 without tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py:17-19
# card vs CPU, fp32 logits of one full-width mixed step: both sides sum in
# fp32 in other orders over 24 layers.  Readings on an H100 SXM are 5.5e-7
# to 6.3e-7 relative; 1e-5 leaves a factor 16 over them, while one bf16
# rounding of the activations (2**-8 = 3.9e-3 relative) is 400 times larger
PARITY_REL_TOL = 1e-5

REPLACES = {
    "monarch_fused": "src/repro/kernels/monarch.py:58",
    "bdmm": "src/repro/kernels/bdmm.py:49",
    "paged_attention_span": "src/repro/kernels/paged.py:196",
}
SOURCES = {
    "monarch_fused": "src/repro_torch/kernels/csrc/monarch.cu",
    "bdmm": "src/repro_torch/kernels/csrc/bdmm.cu",
    "paged_attention_span": "src/repro_torch/kernels/csrc/paged.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def bound_ms(n_bytes: float, flops: float,
             all_bf16: bool) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate, or operations
    over the peak rate of their type (bf16 where every operand is bf16,
    else fp32 outside the tensor cores), whichever is larger."""
    peak = BF16_FLOPS_PER_S if all_bf16 else FP32_FLOPS_PER_S
    tb, tf = n_bytes / HBM_BYTES_PER_S, flops / peak
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    from repro_torch import tree_to
    from repro_torch.configs import get_config
    from repro_torch.core.monarch import (init_monarch, make_dims,
                                          monarch_to_dense)
    from repro_torch.kernels import build_all, launches, reset_launches
    from repro_torch.kernels import ops
    from repro_torch.kernels.bdmm import bdmm, bdmm_plain
    from repro_torch.kernels.monarch import (fused_fits, monarch_fused,
                                             monarch_fused_plain)
    from repro_torch.kernels.paged import (GLOBAL_WINDOW,
                                           paged_attention_span,
                                           paged_attention_span_plain)
    from repro_torch.models import transformer as T
    from repro_torch.serving import ContinuousBatchingEngine, SamplingParams

    # fp32 products in full precision everywhere (PyTorch's default for
    # matmul; stated so no environment can turn TF32 on under the check)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    per_source = build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": per_source, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    def time_ms(fn, iters: int = 20) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    def close(out, ref, dtype_name: str) -> tuple[float, bool]:
        o, r = out.float(), ref.float()
        tol = TOL[dtype_name]
        err = (o - r).abs()
        ok = bool(torch.isfinite(o).all()) and bool(
            (err <= tol + tol * r.abs()).all())
        return float(err.max()) if err.numel() else 0.0, ok

    errs = {k: 0.0 for k in REPLACES}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # -- 2a. monarch_fused at gpt2-medium's three Monarch shapes -------------
    gpt2 = get_config("gpt2-medium")
    layer_shapes = {"attn_1024x1024": (1024, 1024),
                    "w1_1024x4096": (1024, 4096),
                    "w2_4096x1024": (4096, 1024)}
    factors = {}
    for name, (din, dout) in layer_shapes.items():
        dims = make_dims(din, dout, policy=gpt2.monarch.policy)
        factors[name] = init_monarch(gen, dims, device=dev)
        require(fused_fits(dims.l_shape, dims.r_shape),
                f"gpt2-medium {name} must take the fused branch")
    for name, (din, dout) in layer_shapes.items():
        L, R = factors[name]["L"], factors[name]["R"]
        params = L.numel() + R.numel()
        for T_ in (1, 8, 64, 512):
            for xdt in (torch.float32, torch.bfloat16):
                dn = str(xdt).split(".")[1]
                x = randn(T_, din, dtype=xdt)
                err, ok = close(monarch_fused(x, L, R),
                                monarch_fused_plain(x, L, R), dn)
                torch.cuda.synchronize()
                errs["monarch_fused"] = max(errs["monarch_fused"], err)
                W = monarch_to_dense(L, R).to(xdt)
                xb = x.element_size()
                bms, by = bound_ms(T_ * (din + dout) * xb + params * 4,
                                   2 * T_ * params, all_bf16=False)
                emit({"phase": "kernel", "kernel": "monarch_fused",
                      "shape": name, "T": T_, "x_dtype": dn,
                      "factor_dtype": "float32", "max_abs_err": err,
                      "tol": TOL[dn],
                      "kernel_ms": time_ms(lambda: monarch_fused(x, L, R)),
                      "plain_ms": time_ms(
                          lambda: monarch_fused_plain(x, L, R)),
                      "library_ms": time_ms(lambda: torch.matmul(x, W)),
                      "bound_ms": bms, "bound_by": by})
                require(ok, f"monarch_fused {name} T={T_} {dn}: err {err}")

    # -- 2b. bdmm directly and through the staged monarch_mm branch ----------
    sd = make_dims(4096, 4096, nblocks=128)
    require(not fused_fits(sd.l_shape, sd.r_shape),
            "make_dims(4096, 4096, nblocks=128) must exceed the fused fit")
    sf = init_monarch(gen, sd, device=dev)
    for T_ in (8, 512):
        for xdt in (torch.float32, torch.bfloat16):
            dn = str(xdt).split(".")[1]
            x3 = randn(T_, sd.k, sd.p, dtype=xdt)
            w = sf["L"]
            err, ok = close(bdmm(x3, w), bdmm_plain(x3, w), dn)
            errs["bdmm"] = max(errs["bdmm"], err)
            xt = x3.transpose(0, 1)
            wt = w.to(xdt).transpose(1, 2)
            bms, by = bound_ms(
                T_ * sd.k * (sd.p + sd.q) * x3.element_size() + w.numel() * 4,
                2 * T_ * w.numel(), all_bf16=False)
            emit({"phase": "kernel", "kernel": "bdmm", "shape": "direct",
                  "x": [T_, sd.k, sd.p], "w": list(w.shape), "x_dtype": dn,
                  "max_abs_err": err, "tol": TOL[dn],
                  "kernel_ms": time_ms(lambda: bdmm(x3, w)),
                  "plain_ms": time_ms(lambda: bdmm_plain(x3, w)),
                  "library_ms": time_ms(lambda: torch.matmul(xt, wt)),
                  "bound_ms": bms, "bound_by": by})
            require(ok, f"bdmm direct T={T_} {dn}: err {err}")
            x = randn(T_, sd.din, dtype=xdt)
            before = launches()
            y = ops.monarch_mm(x, sf["L"], sf["R"])
            after = launches()
            require(after["bdmm"] - before["bdmm"] == 2
                    and after["monarch_fused"] == before["monarch_fused"],
                    "staged monarch_mm must launch bdmm twice")
            err, ok = close(y, monarch_fused_plain(x, sf["L"], sf["R"]), dn)
            errs["bdmm"] = max(errs["bdmm"], err)
            emit({"phase": "kernel", "kernel": "bdmm",
                  "shape": "staged monarch_mm 4096x4096 nblocks=128", "T": T_,
                  "x_dtype": dn, "max_abs_err": err, "tol": TOL[dn]})
            require(ok, f"staged monarch_mm T={T_} {dn}: err {err}")

    # -- 2c. paged_attention_span -------------------------------------------
    B, H, KV, hd, pg, max_len = 8, 16, 16, 64, 16, 1024
    MP = max_len // pg
    P = 1 + B * MP
    prng = np.random.default_rng(0)
    pt = torch.from_numpy(prng.permutation(np.arange(1, P)).reshape(B, MP)
                          .astype(np.int32)).to(dev)
    k32, v32 = randn(P, pg, KV, hd), randn(P, pg, KV, hd)
    cases = {
        "decode": (1, [0, 15, 16, 100, 511, 700, 1000, 1023],
                   [1] * 8),
        "prefill": (64, [0, 64, 128, 300, 500, 900, 960, 0],
                    [64, 64, 30, 64, 1, 64, 64, 0]),
        # a span of 8 query tiles; valid rows end inside and at tile edges
        "prefill512": (512, [0, 512, 100, 0, 300, 500, 0, 700],
                       [512, 512, 200, 65, 1, 300, 0, 128]),
    }
    paged_summary = None
    for cname, (S, starts, spans) in cases.items():
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        sl = torch.tensor(spans, dtype=torch.int32, device=dev)
        for win in (GLOBAL_WINDOW, 48):
            for dt in (torch.float32, torch.bfloat16):
                dn = str(dt).split(".")[1]
                q = randn(B, S, H, hd, dtype=dt)
                kp, vp = k32.to(dt), v32.to(dt)
                args = (q, kp, vp, pt, st, sl, win)
                err, ok = close(paged_attention_span(*args),
                                paged_attention_span_plain(*args), dn)
                errs["paged_attention_span"] = max(
                    errs["paged_attention_span"], err)
                # pages and attended (query, key) pairs this data needs
                n_pages, n_pairs = 0, 0
                for b in range(B):
                    if spans[b] == 0:
                        continue
                    lo = max(0, starts[b] - win + 1)
                    hi = starts[b] + spans[b] - 1
                    n_pages += min(hi // pg, MP - 1) - lo // pg + 1
                    for i in range(spans[b]):
                        qp = starts[b] + i
                        n_pairs += qp - max(0, qp - win + 1) + 1
                eb = q.element_size()
                bms, by = bound_ms(
                    2 * B * S * H * hd * eb + 2 * n_pages * pg * KV * hd * eb,
                    4 * hd * H * n_pairs, all_bf16=dt == torch.bfloat16)
                # library yardstick: SDPA over pre-gathered contiguous KV
                T_all = MP * pg
                kk = kp[pt.long()].reshape(B, T_all, KV, hd).transpose(1, 2)
                vv = vp[pt.long()].reshape(B, T_all, KV, hd).transpose(1, 2)
                qq = q.transpose(1, 2)
                t = torch.arange(T_all, device=dev)[None, None, :]
                qpos = st.long()[:, None] + torch.arange(S, device=dev)[None]
                mask = ((t <= qpos[..., None])
                        & (qpos[..., None] - t < win))[:, None]
                line = {
                    "phase": "kernel", "kernel": "paged_attention_span",
                    "case": cname, "S": S, "window": win, "dtype": dn,
                    "B": B, "H": H, "KV": KV, "hd": hd, "page": pg,
                    "pages_read": n_pages, "max_abs_err": err,
                    "tol": TOL[dn],
                    "kernel_ms": time_ms(lambda: paged_attention_span(*args)),
                    "plain_ms": time_ms(
                        lambda: paged_attention_span_plain(*args)),
                    "library_ms": time_ms(
                        lambda: F.scaled_dot_product_attention(
                            qq, kk, vv, attn_mask=mask)),
                    "bound_ms": bms, "bound_by": by}
                emit(line)
                require(ok, f"paged {cname} window={win} {dn}: err {err}")
                if (cname == "decode" and win == GLOBAL_WINDOW
                        and dt == torch.bfloat16):
                    paged_summary = line

    # -- 2d. the remaining dtype templates: bf16 factors and weights, and
    # queries in the other width than their pages ----------------------------
    f32, bf16 = torch.float32, torch.bfloat16
    for name, (din, dout) in layer_shapes.items():
        Lb, Rb = (factors[name][k].to(bf16) for k in ("L", "R"))
        for xdt in (f32, bf16):
            dn = str(xdt).split(".")[1]
            x = randn(8, din, dtype=xdt)
            err, ok = close(monarch_fused(x, Lb, Rb),
                            monarch_fused_plain(x, Lb, Rb), dn)
            errs["monarch_fused"] = max(errs["monarch_fused"], err)
            emit({"phase": "kernel_dtypes", "kernel": "monarch_fused",
                  "shape": name, "T": 8, "x_dtype": dn,
                  "factor_dtype": "bfloat16", "max_abs_err": err,
                  "tol": TOL[dn]})
            require(ok, f"monarch_fused bf16 factors {name} {dn}: {err}")
    wb = sf["L"].to(bf16)
    for xdt in (f32, bf16):
        dn = str(xdt).split(".")[1]
        x3 = randn(64, sd.k, sd.p, dtype=xdt)
        err, ok = close(bdmm(x3, wb), bdmm_plain(x3, wb), dn)
        errs["bdmm"] = max(errs["bdmm"], err)
        emit({"phase": "kernel_dtypes", "kernel": "bdmm", "T": 64,
              "x_dtype": dn, "w_dtype": "bfloat16", "max_abs_err": err,
              "tol": TOL[dn]})
        require(ok, f"bdmm bf16 weights {dn}: {err}")
    S, starts, spans = cases["prefill"]
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    sl = torch.tensor(spans, dtype=torch.int32, device=dev)
    for qdt, kdt in ((f32, bf16), (bf16, f32)):
        dn = str(qdt).split(".")[1]
        args = (randn(B, S, H, hd, dtype=qdt), k32.to(kdt), v32.to(kdt), pt,
                st, sl, 48)
        err, ok = close(paged_attention_span(*args),
                        paged_attention_span_plain(*args), dn)
        errs["paged_attention_span"] = max(errs["paged_attention_span"], err)
        emit({"phase": "kernel_dtypes", "kernel": "paged_attention_span",
              "S": S, "window": 48, "q_dtype": dn,
              "page_dtype": str(kdt).split(".")[1], "max_abs_err": err,
              "tol": TOL[dn]})
        require(ok, f"paged q {dn} pages {kdt}: {err}")

    # -- per-kernel summary: one layer of a bf16 decode step (T = 8) --------
    proj = [(1024, 1024)] * 4 + [(1024, 4096), (4096, 1024)]
    T_dec = 8
    xs = [randn(T_dec, din, dtype=torch.bfloat16) for din, _ in proj]

    def layer_factors(nblocks):
        return [init_monarch(gen, make_dims(din, dout, policy="paper",
                                            nblocks=nblocks), device=dev)
                for din, dout in proj]

    def layer_bound(fs, staged: bool):
        """bf16 activations in and out of each launch, fp32 factors."""
        n_bytes = flops = 0
        for f in fs:
            k, q, p = f["L"].shape
            s = f["R"].shape[1]
            n = f["L"].numel() + f["R"].numel()
            acts = k * p + q * s + (2 * k * q if staged else 0)
            n_bytes += T_dec * acts * 2 + n * 4
            flops += 2 * T_dec * n
        return bound_ms(n_bytes, flops, all_bf16=False)

    summary = {}
    fs = layer_factors(None)
    dense = [monarch_to_dense(f["L"], f["R"]).to(torch.bfloat16) for f in fs]
    bms, by = layer_bound(fs, staged=False)
    summary["monarch_fused"] = {
        "ms": time_ms(lambda: [monarch_fused(x, f["L"], f["R"])
                               for x, f in zip(xs, fs)]),
        "plain_ms": time_ms(lambda: [monarch_fused_plain(x, f["L"], f["R"])
                                     for x, f in zip(xs, fs)]),
        "library_ms": time_ms(lambda: [torch.matmul(x, W)
                                       for x, W in zip(xs, dense)]),
        "bound_ms": bms, "bound_by": by}

    fs = layer_factors(128)
    require(not any(fused_fits(f["L"].shape, f["R"].shape) for f in fs),
            "every nblocks=128 projection must take the staged branch")
    fs_bf16 = [{k: v.to(torch.bfloat16) for k, v in f.items()} for f in fs]

    def staged(fn, factors):
        def run():
            for x, f in zip(xs, factors):
                k, _, p = f["L"].shape
                u = fn(x.view(-1, k, p), f["L"])
                fn(u.transpose(1, 2), f["R"])
        return run

    def bmm(x, w):  # one batched torch.matmul per stage
        return torch.matmul(x.transpose(0, 1), w.transpose(1, 2)
                            ).transpose(0, 1)

    bms, by = layer_bound(fs, staged=True)
    summary["bdmm"] = {"ms": time_ms(staged(bdmm, fs)),
                       "plain_ms": time_ms(staged(bdmm_plain, fs)),
                       "library_ms": time_ms(staged(bmm, fs_bf16)),
                       "bound_ms": bms, "bound_by": by}
    summary["paged_attention_span"] = {
        k: paged_summary[k2] for k, k2 in (
            ("ms", "kernel_ms"), ("plain_ms", "plain_ms"),
            ("library_ms", "library_ms"), ("bound_ms", "bound_ms"),
            ("bound_by", "bound_by"))}

    # -- 3. serve gpt2-medium at full width ---------------------------------
    def serve(cfg, params, n_req, lo, hi, new_tokens, seed):
        eng = ContinuousBatchingEngine(
            cfg, params, max_slots=8, page_size=16, max_len=1024,
            chunk_size=64, use_paged_kernel=True)
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab, int(rng.integers(lo, hi + 1)))
                   for _ in range(n_req)]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        reqs = [eng.add_request(p, SamplingParams(max_new_tokens=new_tokens))
                for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launches()
        for r in reqs:
            require(len(r.output_tokens) == new_tokens
                    and all(0 <= t < cfg.vocab for t in r.output_tokens),
                    "every request returns its tokens, all in the vocab")
        eng.pool_host.check_invariants()
        out = sum(len(r.output_tokens) for r in reqs)
        return eng, reqs, counts, dt, out, sum(len(p) for p in prompts)

    cfg = dataclasses.replace(gpt2, monarch=dataclasses.replace(
        gpt2.monarch, backend="pallas"))
    params = T.init_params(cfg, seed=0, device=dev)
    serve(cfg, params, 2, 32, 64, 4, seed=1)           # warm-up, not counted
    eng, reqs, counts, dt, out, prompt_toks = serve(cfg, params, 8, 32, 256,
                                                    32, seed=0)
    st_ = eng.stats
    emit({"phase": "serve", "model": "gpt2-medium", "dtype": cfg.dtype,
          "layers": cfg.n_layers, "requests": len(reqs),
          "prompt_tokens": prompt_toks, "new_tokens": out,
          "seconds": dt, "tokens_per_s": out / dt,
          "steps": st_["mixed_steps"],
          "kernel_dispatches": st_["kernel_dispatches"],
          "dense_fallbacks": st_["dense_fallbacks"], "launches": counts})
    require(counts["monarch_fused"] > 0, "serve launched no monarch_fused")
    require(counts["paged_attention_span"] > 0,
            "serve launched no paged_attention_span")
    require(st_["dense_fallbacks"] == 0, "serve fell back to dense attention")
    serve_counts = dict(counts)
    del eng

    # where a step's time goes: wall clock of synchronized steps, and the
    # device's kernel time from torch.profiler (first the prefill steps of
    # a fresh batch, then decode steps once every request is decoding)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def window(eng, n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_steps):
                eng.step()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue  # host ops also carry their kernels' device time
            dt = getattr(e, "self_device_time_total", None)
            if dt is None:
                dt = e.self_cuda_time_total
            rows.append((dt / 1e3 / n_steps, e.key[:70], e.count))
        rows.sort(reverse=True)
        device = sum(r[0] for r in rows)
        return {"wall_ms_per_step": wall * 1e3,
                "device_ms_per_step": device,
                "device_busy_share": device / (wall * 1e3),
                "top_kernels_ms_per_step": [
                    [name, ms, n / n_steps] for ms, name, n in rows[:8]]}

    eng = ContinuousBatchingEngine(cfg, params, max_slots=8, page_size=16,
                                   max_len=1024, chunk_size=64,
                                   use_paged_kernel=True)
    rng = np.random.default_rng(4)
    for _ in range(8):
        eng.add_request(rng.integers(0, cfg.vocab, 256),
                        SamplingParams(max_new_tokens=64))
    prefill = window(eng, 1)
    while any(s.request.state.value != "running"
              for s in eng.running.values()):
        eng.step()
    decode = window(eng, 8)
    emit({"phase": "serve_profile", "prefill_T512": prefill,
          "decode_T8": decode})
    del eng, params

    cfg_st = dataclasses.replace(gpt2, monarch=dataclasses.replace(
        gpt2.monarch, backend="pallas", nblocks=128))
    params = T.init_params(cfg_st, seed=0, device=dev)
    eng, reqs, counts, dt, out, prompt_toks = serve(cfg_st, params, 4, 32, 64,
                                                    8, seed=2)
    emit({"phase": "serve_staged", "model": "gpt2-medium nblocks=128",
          "requests": len(reqs), "new_tokens": out, "seconds": dt,
          "tokens_per_s": out / dt, "steps": eng.stats["mixed_steps"],
          "dense_fallbacks": eng.stats["dense_fallbacks"],
          "launches": counts})
    require(counts["bdmm"] > 0 and counts["monarch_fused"] == 0,
            "the nblocks=128 serve must take the staged bdmm branch only")
    require(counts["paged_attention_span"] > 0,
            "staged serve launched no paged_attention_span")
    serve_counts["bdmm"] = counts["bdmm"]
    del eng, params

    # -- 4. card vs CPU at full width, fp32 ---------------------------------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p_gpu = T.init_params(cfg32, seed=3, device=dev)
    p_cpu = tree_to(p_gpu, "cpu")
    Bp, Sp, mpp = 4, 64, 8
    prng = np.random.default_rng(3)
    toks = prng.integers(0, cfg.vocab, (Bp, Sp)).astype(np.int32)
    table = (1 + np.arange(Bp * mpp, dtype=np.int32)).reshape(Bp, mpp)
    spans_np = np.array([64, 40, 17, 1], np.int32)
    logits = {}
    for d in (dev, torch.device("cpu")):
        pool = T.init_paged_pool(cfg32, 1 + Bp * mpp, 16, device=d)
        lg, _ = T.paged_mixed_step(
            p_gpu if d.type == "cuda" else p_cpu,
            torch.from_numpy(toks).to(d), torch.zeros(Bp, dtype=torch.int32,
                                                      device=d),
            torch.from_numpy(spans_np).to(d), torch.from_numpy(table).to(d),
            pool, cfg32)
        logits[d.type] = lg[:, :cfg.vocab].float().cpu()
    diff = (logits["cuda"] - logits["cpu"]).abs()
    rel = float(diff.max() / logits["cpu"].abs().max())
    emit({"phase": "parity_step", "max_abs_err": float(diff.max()),
          "max_rel_err": rel, "rel_tol": PARITY_REL_TOL,
          "finite": bool(torch.isfinite(logits["cuda"]).all())})
    require(bool(torch.isfinite(logits["cuda"]).all()), "non-finite logits")
    require(rel <= PARITY_REL_TOL, f"card vs CPU logits differ: rel {rel}")

    # random weights often decode one token over and over, so beyond token
    # identity every step's logits (rows with a span) are held to the
    # same limit as the single step above
    step_logits: list = []
    mixed_step = T.paged_mixed_step

    def recording_step(params, tokens, start, span, *args, **kw):
        lg, pool = mixed_step(params, tokens, start, span, *args, **kw)
        step_logits.append(lg[span > 0, :cfg.vocab].float().cpu())
        return lg, pool

    T.paged_mixed_step = recording_step
    prefix = list(prng.integers(0, cfg.vocab, 40))
    shared = [np.asarray(prefix + [(17 * i + j) % cfg.vocab
                                   for j in range(3 + i % 2)])
              for i in range(4)]
    traces = {
        # (engine options, prompts, add one request every n steps; 0: all
        # at once)
        "plain": (dict(max_slots=4, max_len=128, chunk_size=64),
                  [prng.integers(0, cfg.vocab, int(n))
                   for n in (16, 33, 48, 64)], 0),
        # 8 usable pages for 14 pages of demand: preemptions mid-flight
        "preemption": (dict(max_slots=4, max_len=128, chunk_size=16,
                            n_pages=9),
                       [prng.integers(0, cfg.vocab, int(n))
                        for n in (16, 33, 48, 64)], 0),
        # a shared 40-token prefix; the repeat of the second prompt and
        # the extension of the first match a committed partial page and
        # fork it copy-on-write
        "prefix_cow": (dict(max_slots=4, max_len=128, chunk_size=16),
                       shared + [shared[1],
                                 np.concatenate([shared[0], [5, 6]])], 3),
    }
    stat_keys = ("mixed_steps", "preemptions", "prefix_hit_tokens",
                 "cow_forks", "kernel_dispatches", "dense_fallbacks")
    for tname, (kw, prompts, stagger) in traces.items():
        outs, stats, seen = {}, {}, {}
        for d in ("cuda", "cpu"):
            step_logits.clear()
            eng = ContinuousBatchingEngine(
                cfg32, p_gpu if d == "cuda" else p_cpu, page_size=16,
                use_paged_kernel=True, device=d, **kw)
            reset_launches()
            pending, reqs, steps = list(prompts), [], 0
            while pending or eng.has_work():
                if pending and (stagger == 0 or steps % stagger == 0):
                    while pending:
                        reqs.append(eng.add_request(
                            pending.pop(0), SamplingParams(max_new_tokens=8)))
                        if stagger:
                            break
                eng.step()
                steps += 1
                require(steps < 1000, f"trace {tname} on {d} did not finish")
            eng.pool_host.check_invariants()
            outs[d] = [list(r.output_tokens) for r in reqs]
            stats[d] = {k: eng.stats[k] for k in stat_keys}
            seen[d] = list(step_logits)
            if d == "cuda":
                counts = launches()
        require(len(seen["cuda"]) == len(seen["cpu"]) and all(
            a.shape == b.shape for a, b in zip(seen["cuda"], seen["cpu"])),
            f"trace {tname}: card and CPU ran other steps")
        step_rel = max(float((a - b).abs().max() / b.abs().max())
                       for a, b in zip(seen["cuda"], seen["cpu"]))
        emit({"phase": "parity_tokens", "trace": tname, "cuda": outs["cuda"],
              "cpu": outs["cpu"], "identical": outs["cuda"] == outs["cpu"],
              "steps_compared": len(seen["cuda"]),
              "max_step_rel_err": step_rel, "rel_tol": PARITY_REL_TOL,
              "stats": stats["cuda"], "launches": counts})
        require(outs["cuda"] == outs["cpu"],
                f"trace {tname}: card and CPU greedy tokens differ")
        require(stats["cuda"] == stats["cpu"],
                f"trace {tname}: card and CPU engine stats differ")
        require(all(len(o) == 8 for o in outs["cuda"]),
                f"trace {tname}: a request returned too few tokens")
        require(step_rel <= PARITY_REL_TOL,
                f"trace {tname}: card and CPU step logits differ: {step_rel}")
        require(counts["monarch_fused"] > 0
                and counts["paged_attention_span"] > 0
                and stats["cuda"]["dense_fallbacks"] == 0,
                f"trace {tname}: the card did not run the kernels")
        if tname == "preemption":
            require(stats["cuda"]["preemptions"] > 0,
                    "the preemption trace preempted nothing")
        if tname == "prefix_cow":
            require(stats["cuda"]["prefix_hit_tokens"] > 0
                    and stats["cuda"]["cow_forks"] > 0,
                    "the prefix trace forked no page")
    T.paged_mixed_step = mixed_step

    # -- summary --------------------------------------------------------------
    kernels = []
    for name in ("monarch_fused", "bdmm", "paged_attention_span"):
        s = summary[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": serve_counts[name],
            "max_abs_err": errs[name], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
