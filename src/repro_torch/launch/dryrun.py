"""Single-pod dry run: count every (arch x shape) cell's step as one rank
of the production mesh runs it (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell on 512 placeholder host
devices and reads the executable.  The port traces instead: one rank of
``launch.mesh.make_production_mesh()`` (data 16 x model 16, shape-only
groups, device ``meta``) runs the port's own step once on ``meta``
tensors of that rank's shards -- built from ``transformer.param_shapes``
and the placements, never drawn -- under ``hlo_analysis.count_step``.
Nothing needs a card.

Per cell (``results/dryrun_torch/<arch>__<shape>__pod16x16__<variant>.json``):

* ``memory``: ``argument_size_in_bytes`` (the rank's train state or
  params, its batch rows and its decode cache), ``output_size_in_bytes``,
  ``temp_size_in_bytes`` (the traced peak less the arguments),
  ``alias_size_in_bytes`` (the decode cache written in place; the train
  state the step replaces) and ``peak_size_in_bytes``;
* ``flops_full`` / ``bytes_full`` / ``coll_full``: the whole step's
  product FLOPs, bytes accessed and collective operand bytes by kind
  (``coll_counts``: how many of each).  The port's loops are eager and
  every layer is counted, so nothing is corrected by trip counts;
* ``bodies``: one layer of each kind traced alone with its trips (the
  reference's ``_body_defs`` choices), a breakdown: a serving step's
  total changes by exactly its bodies when a layer (a hybrid: a group)
  goes; a train step's body is the layer's forward and backward under
  the config's remat, without the FSDP gathers and the optimizer;
* ``roofline``: ``hlo_analysis.RooflineTerms`` at the H100's data-sheet
  rates, ``model_flops`` from the reference's formula;
* ``rank`` and ``symmetric``: the rank traced, rank 0 unless some rank's
  shard shapes differ from rank 0's (then the rank with the most
  argument bytes).

The steps: ``make_train_step(cfg, accum_steps=, mesh=)`` on a state cut
from ``train_shardings(cfg, mesh, shape)`` (masters, both moments, the
rank's rows); ``make_prefill_step(cfg, plan=)`` and
``make_decode_step(cfg, plan=)`` on the rank's ``"model"`` shards (whole
over ``"data"``, as the port serves), its rows and
``init_decode_cache(..., plan=, device="meta")`` (plus ``enc_out`` for
an encoder-decoder).  A batch the data axis does not divide (long_500k's
single row) stays whole on every rank, as the reference's guard leaves
it.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-moe-1b-a400m --shape train_4k
  python -m repro_torch.launch.dryrun --all --single-pod-only [--resume]

The multi-pod mesh (``--multi-pod``, ``--multi-pod-only``, and ``--all``
without ``--single-pod-only``) and the ``a2a`` Monarch scheme are not
ported and raise ``NotImplementedError``; the schemes ``auto`` and
``psum`` both mean the port's Megatron placement
(``sharding.params``).
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
import types
from pathlib import Path

import torch
from torch.utils._pytree import tree_leaves

from repro_torch import tree_map
from repro_torch.configs import PORTED_ARCHS, get_config
from repro_torch.configs.shapes import (SHAPES, cell_supported,
                                        enc_out_specs, input_specs)
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import PRODUCTION_MESH, make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWState
from repro_torch.sharding import params as SP

ROOT = Path(__file__).resolve().parents[3]
RESULTS_DIR = ROOT / "results" / "dryrun_torch"


def _cell_name(arch, shape, variant):
    return f"{arch}__{shape}__pod16x16__{variant}"


def _refuse(multi_pod: bool, scheme: str) -> None:
    if multi_pod:
        raise NotImplementedError(
            "multi-pod cells need the 'pod' axis, not ported yet "
            "(ROADMAP.md §A)")
    if scheme == "a2a":
        raise NotImplementedError(
            "the a2a Monarch scheme is not ported (ROADMAP.md §A); 'auto' "
            "and 'psum' are the port's Megatron placement")
    if scheme not in ("auto", "psum"):
        raise ValueError(f"unknown scheme {scheme!r}")


# ---------------------------------------------------------------------------
# One rank's arguments, as meta tensors
# ---------------------------------------------------------------------------


def _whole(cfg) -> dict:
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), T.param_shapes(cfg))


def splits_rows(cfg, batch: dict, mesh, accum_steps: int = 1) -> bool:
    """Whether each data rank can take its rows of ``batch``
    (``steps.shard_batch``): not where the data axis does not divide
    the rows (long_500k's one row), nor where a rank's rows would cut an
    MoE routing group (``layers.moe_group_size``: a decode batch of 128
    tokens is one group)."""
    tokens = batch["tokens"]
    B, tok = tokens.shape[0], tokens[0].numel()
    if B % (mesh.data * accum_steps):
        return False
    if cfg.moe is None:
        return True
    try:
        L.moe_group_size(cfg.moe, B // (mesh.data * accum_steps) * tok,
                         types.SimpleNamespace(mesh=mesh))
    except ValueError:
        return False
    return True


def step_mesh(cfg, shape: str, mesh):
    """The mesh a rank's step of the ``shape`` cell runs on: ``mesh``;
    at a serving cell whose batch the data axis cannot split
    (:func:`splits_rows`), the rank's model group alone (data 1): every
    data rank then serves the whole batch as a replica of its model
    group, as the reference's guard leaves a batch its axis does not
    divide whole, and as the port serves across data ranks (the
    continuous-batching engine refuses ``data > 1``; replicas are the
    router's)."""
    from repro_torch.launch.mesh import shape_mesh

    if SHAPES[shape].step == "train" or splits_rows(
            cfg, _inputs(cfg, shape), mesh):
        return mesh
    return shape_mesh(1, mesh.model, rank=mesh.model_rank,
                      backend=mesh.backend)


def _rows(batch: dict, mesh, accum_steps: int = 1) -> dict:
    """The rank's rows of a meta batch (``steps.shard_batch``), tensors
    of their own as a rank holds them."""
    return {k: v.clone()
            for k, v in S.shard_batch(batch, mesh, accum_steps).items()}


def _inputs(cfg, shape: str, dtype=torch.bfloat16) -> dict:
    """The cell's batch (``configs.shapes.input_specs``), with an
    encoder-decoder's ``enc_out`` at a decode cell."""
    batch = input_specs(cfg, shape, dtype)
    if SHAPES[shape].step == "decode" and cfg.encdec:
        batch["enc_out"] = enc_out_specs(cfg, shape, dtype)
    return batch


def _serve_params(cfg, mesh):
    """(plan, the rank's ``"model"`` shards, whole over ``"data"``)."""
    plan = SP.tp_plan(T.param_shapes(cfg), cfg, mesh)
    table = SP.placements(T.param_shapes(cfg), plan, fsdp=False)
    return plan, SP.keep_parts(_whole(cfg), "", table, plan)


def train_state(cfg, mesh=None) -> dict:
    """A train state of ``make_train_step(cfg, mesh=mesh)`` as meta
    tensors: the whole state (``train_shardings``' ``state_shape``: fp32
    masters, both moments, the 0-d int32 step) cut to ``mesh``'s rank's
    shards by its placements; without a mesh, whole."""
    if mesh is None:
        whole = _whole(cfg)
        return {"params": whole, "opt": AdamWState(
            step=torch.empty((), dtype=torch.int32, device="meta"),
            mu=tree_map(torch.empty_like, whole),
            nu=tree_map(torch.empty_like, whole))}
    st = S.train_shardings(cfg, mesh, "train_4k").state_shape
    plan, table = S.train_plan(cfg, mesh)

    def cut(tree):
        return SP.keep_parts(tree, "", table, plan)

    return {"params": cut(st["params"]),
            "opt": AdamWState(step=torch.empty_like(st["opt"].step),
                              mu=cut(st["opt"].mu), nu=cut(st["opt"].nu))}


def count_train_step(cfg, mesh, batch: dict, optimizer=None,
                     accum_steps: int = 1) -> H.StepCount:
    """``count_step`` of ``make_train_step(cfg, optimizer, accum_steps,
    mesh=mesh)`` on :func:`train_state` and the rank's rows of
    ``batch`` (a global batch: meta tensors, or anything with the
    shapes and dtypes of one)."""
    batch = {k: torch.empty(tuple(v.shape), device="meta",
                            dtype=torch.as_tensor(v[:0]).dtype)
             for k, v in batch.items()}
    if mesh is not None:
        batch = _rows(batch, mesh, accum_steps)
    _, step = S.make_train_step(cfg, optimizer, accum_steps=accum_steps,
                                mesh=mesh)
    return H.count_step(step, train_state(cfg, mesh), batch)


def _arguments(cfg, shape: str, mesh, accum_steps: int = 1):
    """(plan, the step's arguments as a tuple of meta trees) of the
    ``shape`` cell on ``mesh``'s rank (a :func:`step_mesh`)."""
    cell = SHAPES[shape]
    if cell.step == "train":
        batch = S.train_shardings(cfg, mesh, shape).batch_shape
        return (S.train_plan(cfg, mesh)[0],
                (train_state(cfg, mesh), _rows(batch, mesh, accum_steps)))
    plan, params = _serve_params(cfg, mesh)
    rows = _rows(_inputs(cfg, shape), mesh)
    if cell.step == "prefill":
        return plan, (params, rows)
    tokens = rows["tokens"]
    cache = T.init_decode_cache(cfg, tokens.shape[0], cell.seq_len,
                                device="meta", plan=plan)
    args = (params, tokens, cache)
    if cfg.encdec:
        args += (rows["enc_out"],)
    return plan, args


def _shapes(args) -> list:
    return [(tuple(t.shape), t.dtype) for t in tree_leaves(args)]


def _nbytes(args) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(args))


def rank_symmetry(cfg, shape: str, accum_steps: int = 1,
                  mesh_shape: tuple = PRODUCTION_MESH) -> tuple[bool, int]:
    """(every rank's arguments have rank 0's shapes, the rank to trace:
    0 where they do, else the one whose arguments hold the most
    elements).  Each rank's parameter shards are cut from the whole tree
    by the placements (computed from shapes alone, the same on every
    rank) at its own indices, its rows taken by its data index and its
    decode cache made by its plan (a train state's moments are placed as
    its masters)."""
    from repro_torch.launch.mesh import shape_mesh

    cell = SHAPES[shape]
    data, model = mesh_shape
    mesh0 = step_mesh(cfg, shape, shape_mesh(data, model))
    if cell.step == "train":
        plan0, table = S.train_plan(cfg, mesh0)
    else:
        plan0 = SP.tp_plan(T.param_shapes(cfg), cfg, mesh0)
        table = SP.placements(T.param_shapes(cfg), plan0, fsdp=False)
    whole, batch = _whole(cfg), _inputs(cfg, shape)
    ref, best, most = None, 0, -1
    same = True
    for r in range(data * model):
        mesh = step_mesh(cfg, shape, shape_mesh(data, model, rank=r))
        plan = dataclasses.replace(plan0, mesh=mesh)
        rows = _rows(batch, mesh, accum_steps)
        shapes = _shapes((SP.keep_parts(whole, "", table, plan), rows))
        if cell.step == "decode":
            shapes += _shapes(T.init_decode_cache(
                cfg, rows["tokens"].shape[0], cell.seq_len, device="meta",
                plan=plan))
        ref = shapes if ref is None else ref
        same &= shapes == ref
        n = sum(math.prod(s) for s, _ in shapes)
        if n > most:
            best, most = r, n
    return same, 0 if same else best


# ---------------------------------------------------------------------------
# Bodies: one layer of each kind alone
# ---------------------------------------------------------------------------


def _own(tree):
    """A subtree as meta tensors of their own (a layer's slice of a
    stacked tree is a view)."""
    return tree_map(lambda t: t.clone(), tree)


def _layer(stacked, depth: int = 1):
    for _ in range(depth):
        stacked = T.layer_params(stacked, 0)
    return _own(stacked)


def _body_defs(cfg, shape_name: str, mesh, step_kind: str):
    """[(name, trips, fn, args)]: each layer kind of ``cfg``'s stack as the
    step runs it, alone on the rank's shards (a train step's layers after
    the FSDP gather: whole over ``"data"``).  A serving body runs the
    step's own per-layer code: the cast of the layer's stacked leaves,
    then the block; a train body the layer's forward (under the config's
    remat) and backward to its params and input."""
    cell = SHAPES[shape_name]
    plan, params = _serve_params(cfg, mesh)
    dt = T._dtype(cfg)
    specs = _rows(_inputs(cfg, shape_name, dt), mesh)
    rows = specs["tokens"].shape[0]
    if step_kind == "decode":
        S_dec = 1
        cache = T.init_decode_cache(cfg, rows, cell.seq_len, device="meta",
                                    plan=plan)
        enc_out = specs.get("enc_out")
    else:
        S_dec = specs["tokens"].shape[1] + (
            specs["patch_embeds"].shape[1] if "patch_embeds" in specs
            else 0)
        enc_out = (torch.empty((rows, specs["enc_embeds"].shape[1],
                                cfg.d_model), dtype=dt, device="meta")
                   if cfg.encdec else None)

    def x_of(s):
        return torch.empty((rows, s, cfg.d_model), dtype=dt, device="meta")

    def cast(p):
        return S._compute_cast(p, cfg)

    defs = []

    def add(name, trips, apply, p, x, *extra, cast_p=True):
        """``apply(p, x, *extra) -> y``, the layer as the step runs it."""
        if step_kind == "train":
            def fn(p, x, *extra):
                return _train_body(cfg, apply, p, x, extra)
        else:
            def fn(p, x, *extra):
                return apply(cast(p) if cast_p else p, x, *extra)
        defs.append((name, trips, fn, (p, x) + extra))

    if cfg.layer_kind == "attn":
        win = T.layer_windows(cfg)[-1]
        if step_kind == "decode":
            def attn(p, x, c, pos):
                return T.attn_block_apply(p, x, cfg, window=win, cache=c,
                                          pos=pos, enc_out=enc_out,
                                          plan=plan)
            add("attn_layer", cfg.n_layers, attn,
                _layer(params["decoder"]["layers"]), x_of(1),
                _layer(cache["layers"]), torch.empty_like(cache["pos"]))
        else:
            def attn(p, x, aux):
                la = {"lb_loss": torch.zeros_like(aux["lb_loss"])}
                h = T.attn_block_apply(p, x, cfg, window=win,
                                       enc_out=enc_out, plan=plan, aux=la)
                aux["lb_loss"] = aux["lb_loss"] + la["lb_loss"]
                return h
            aux = {"lb_loss": torch.zeros((), device="meta")}
            add("attn_layer", cfg.n_layers, attn,
                _layer(params["decoder"]["layers"]), x_of(S_dec), aux)
        if cfg.encdec and step_kind != "decode":
            enc_cfg = T._enc_cfg(cfg)
            enc_win = T.layer_windows(enc_cfg)[-1]

            def enc(p, x):
                return T.attn_block_apply(p, x, enc_cfg, window=enc_win,
                                          bidir=True, plan=plan)
            add("enc_layer", cfg.n_enc_layers, enc,
                _layer(params["encoder"]["layers"]), enc_out)
        return defs

    def mamba(p, x, *c):
        return T._mamba_layer(p, x, cfg, c[0] if c else None, plan)

    x = x_of(S_dec)
    if cfg.layer_kind == "mamba":
        extra = (_layer(cache["layers"]),) if step_kind == "decode" else ()
        add("mamba_layer", cfg.n_layers, mamba,
            _layer(params["decoder"]["layers"]), x, *extra)
        return defs
    # hybrid: every Mamba layer, then the shared block once a group
    n_groups, _ = T.hybrid_groups(cfg)
    groups = params["decoder"]["groups"]
    extra = (_layer(cache["groups"]["mamba"], 2),) \
        if step_kind == "decode" else ()
    add("mamba_layer", cfg.n_layers, mamba, _layer(groups, 2), x, *extra)

    def shared(p, x, *c):
        if not c:
            return T.attn_block_apply(p, x, cfg, window=None, plan=plan)
        return T.attn_block_apply(p, x, cfg, window=None,
                                  cache={"attn": c[0]}, pos=c[1], plan=plan)
    extra = ((_layer(cache["groups"]["attn"]),
              torch.empty_like(cache["pos"]))
             if step_kind == "decode" else ())
    # the step casts the shared block once, not once a group
    sp = params["decoder"]["shared_attn"]
    add("shared_attn", n_groups, shared,
        _own(sp) if step_kind == "train" else cast(_own(sp)), x, *extra,
        cast_p=False)
    return defs


def _train_body(cfg, apply, p, x, extra):
    """A layer's forward under ``cfg.remat`` on the compute-dtype copy of
    its fp32 masters, and its backward to the masters and its input (the
    reference's body: the gradient of the sum of its fp32 output)."""
    from repro_torch.optim.adamw import leaves_with_paths

    p = tree_map(lambda t: t.detach().requires_grad_(True), p)
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        run = T._maybe_remat(apply, cfg, True)
        y = run(S._compute_cast(p, cfg), x, *extra)
        loss = torch.sum(y.float())
        leaves = [t for _, t in leaves_with_paths(p)] + [x]
        return torch.autograd.grad(loss, leaves, allow_unused=True)


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------


def model_flops(cfg, shape_name: str) -> float:
    """The reference's global model FLOPs: 6 N D (train), 2 N D
    (prefill, D = tokens), 2 N B (decode), N the active parameters less
    an untied embedding table."""
    cell = SHAPES[shape_name]
    n_emb = cfg.vocab * cfg.d_model if not cfg.tie_embeddings else 0
    n_eff = cfg.active_param_count() - n_emb
    if cell.step == "train":
        return float(6 * n_eff * cell.global_batch * cell.seq_len)
    if cell.step == "prefill":
        return float(2 * n_eff * cell.global_batch * cell.seq_len)
    return float(2 * n_eff * cell.global_batch)


def _step_fn(cfg, step_kind: str, mesh, plan, accum_steps: int):
    if step_kind == "train":
        return S.make_train_step(cfg, accum_steps=accum_steps, mesh=mesh)[1]
    if step_kind == "prefill":
        return S.make_prefill_step(cfg, plan=plan)
    return S.make_decode_step(cfg, plan=plan)


def count_cell(cfg, shape_name: str, mesh, accum_steps: int = 1):
    """``count_step`` of the ``shape_name`` cell's step on ``mesh``'s
    rank (on its :func:`step_mesh`): (StepCount, the arguments' bytes
    the step replaces or writes in place)."""
    step_kind = SHAPES[shape_name].step
    mesh = step_mesh(cfg, shape_name, mesh)
    plan, args = _arguments(cfg, shape_name, mesh, accum_steps)
    fn = _step_fn(cfg, step_kind, mesh, plan, accum_steps)
    count = H.count_step(fn, *args)
    alias = (count.aliased_bytes if step_kind == "decode"
             else _nbytes(args[0]) if step_kind == "train" else 0)
    return count, alias


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             variant: str = "paper", overrides: dict | None = None,
             scheme: str = "psum") -> dict:
    _refuse(multi_pod, scheme)
    t0 = time.time()
    cfg = get_config(f"{arch}:{variant}" if variant != "paper" else arch)
    accum_steps = 1
    if overrides:
        overrides = dict(overrides)
        accum_steps = overrides.pop("accum_steps", 1)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
    ok, reason = cell_supported(cfg, shape_name)
    rec = {"arch": arch, "shape": shape_name, "variant": variant,
           "mesh": "16x16"}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec

    symmetric, rank = rank_symmetry(cfg, shape_name, accum_steps)
    mesh = make_production_mesh(rank=rank)
    n_chips = mesh.world
    step_kind = SHAPES[shape_name].step
    count, alias = count_cell(cfg, shape_name, mesh, accum_steps)
    mem = {"argument_size_in_bytes": count.argument_bytes,
           "output_size_in_bytes": count.output_bytes,
           "temp_size_in_bytes": count.peak_bytes - count.argument_bytes,
           "alias_size_in_bytes": alias,
           "peak_size_in_bytes": count.peak_bytes}
    coll_full = H.collective_bytes(count.collectives)
    coll_counts: dict = {}
    for (kind, _, _), n in count.collectives.items():
        coll_counts[kind] = coll_counts.get(kind, 0) + n
    bodies = []
    for name, trips, fn, args in _body_defs(
            cfg, shape_name, step_mesh(cfg, shape_name, mesh), step_kind):
        b = H.count_step(fn, *args)
        bodies.append({"name": name, "trips": trips, "flops": b.flops,
                       "bytes": b.bytes,
                       "coll": H.collective_bytes(b.collectives)})
    terms = H.RooflineTerms(
        hlo_flops=float(count.flops), hlo_bytes=float(count.bytes),
        coll_bytes=float(sum(coll_full.values())), n_chips=n_chips,
        model_flops=model_flops(cfg, shape_name))
    rec.update(status="ok", step=step_kind, n_chips=n_chips, rank=rank,
               symmetric=symmetric,
               rows_split=step_mesh(cfg, shape_name, mesh) is mesh,
               time_trace_s=round(time.time() - t0, 2),
               memory=mem, flops_full=count.flops, bytes_full=count.bytes,
               ops_full=count.ops, coll_full=coll_full,
               coll_counts=coll_counts, bodies=bodies,
               roofline=terms.as_dict())
    return rec


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def _run_all(resume: bool, variant: str, multi_pod_only: bool,
             single_pod_only: bool, archs=None, shapes=None):
    """Every single-pod cell, each in a process of its own (so the
    scheme, ``--set`` and the collective counts never leak between
    cells)."""
    _refuse(multi_pod_only or not single_pod_only, "psum")
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    cells = [(a, s) for a in (archs or PORTED_ARCHS)
             for s in (shapes or SHAPES)]
    done = failed = 0
    t_all = time.time()
    for arch, shape in cells:
        out = RESULTS_DIR / f"{_cell_name(arch, shape, variant)}.json"
        if resume and out.exists():
            done += 1
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--variant", variant,
               "--out", str(out)]
        print(f"[dryrun] {out.stem} ...", flush=True)
        t0 = time.time()
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=3600,
                           env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        dt = time.time() - t0
        if r.returncode != 0 and not out.exists():
            out.write_text(json.dumps({
                "arch": arch, "shape": shape, "variant": variant,
                "mesh": "16x16", "status": "error",
                "error": r.stderr[-3000:]}, indent=1))
        status = json.loads(out.read_text())["status"]
        if status == "error":
            failed += 1
            print(f"  FAILED in {dt:.0f}s: "
                  f"{r.stderr.splitlines()[-1] if r.stderr else '?'}",
                  flush=True)
        else:
            done += 1
            print(f"  {status} in {dt:.0f}s", flush=True)
    print(f"[dryrun] complete: {done} ok or skipped, {failed} failed in "
          f"{time.time() - t_all:.1f}s")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--variant", default="paper",
                    choices=["paper", "dense", "mxu"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override field=value, e.g. "
                         "--set attn_chunk=1024 --set remat=dots")
    ap.add_argument("--scheme", default="auto",
                    choices=["auto", "psum", "a2a"],
                    help="monarch TP scheme (a2a is not ported)")
    args = ap.parse_args()
    _refuse(args.multi_pod or args.multi_pod_only, args.scheme)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v

    if args.all:
        _run_all(args.resume, args.variant, args.multi_pod_only,
                 args.single_pod_only)
        return

    try:
        rec = run_cell(args.arch, args.shape, False, args.variant,
                       overrides=overrides, scheme=args.scheme)
        rec["overrides"] = overrides
        rec["scheme"] = args.scheme
    except Exception:
        rec = {"arch": args.arch, "shape": args.shape,
               "variant": args.variant, "mesh": "16x16", "status": "error",
               "error": traceback.format_exc()[-4000:]}
    out = Path(args.out) if args.out else (
        RESULTS_DIR / f"{_cell_name(args.arch, args.shape, args.variant)}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1, default=float))
    print(json.dumps({k: rec[k] for k in ("arch", "shape", "mesh", "status")}))
    if rec["status"] == "error":
        print(rec["error"][-2000:], file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
