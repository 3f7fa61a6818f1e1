"""Rank side of ``tests/test_torch_train_mesh.py``: training under a
``("data", "model")`` mesh.

``launch.mesh.run_ranks`` starts each rank as a fresh process that imports
this module by name, so it imports ``torch`` and ``repro_torch`` only.
Each rank runs on one CPU thread.  :func:`run_jobs` runs a list of jobs
and returns one result a job.  A job is a dict with ``kind``:

* ``"steps"``: ``make_train_step(cfg, adamw(**opt), accum, compress,
  mesh=)`` from the whole numpy ``params``, over ``batches`` (global
  numpy batches; the rank takes its rows, ``shard_batch``): the
  gradient shards of the first batch (``value_and_grad`` under the
  plan), every step's metrics and the final state's shards.  With
  ``grads`` (a whole numpy gradient tree) every step is fed the rank's
  shards of those gradients in place of its own;
* ``"init"``: ``transformer.init_params(cfg, seed, plan=)``: the rank's
  shards as they are drawn;
* ``"raises"``: one step that must raise ``ValueError``: its message;
* ``"trainer"``: a ``Trainer(mesh=)`` over the ranks' host streams of
  ``data`` from its ``skip``-th batch, checkpointing into ``ckpt_dir``
  (resuming what it holds; with ``from_ckpt``, a checkpoint's step
  directory that rank 0 copies there first): its history's losses;
* ``"mesh_mismatch"``: ``make_host_mesh`` asked for another shape than
  the joined world's: its ``ValueError``'s message;
* ``"serve"``: ``make_prefill_step(cfg, plan)`` on the rank's
  ``"model"`` shards of ``params`` and its rows of ``tokens``: the
  last position's logits;
* ``"collectives"``: one ``make_train_step(cfg, adamw(**opt), mesh=)``
  step on ``params`` and the rank's rows of ``batch``: the collectives
  it issued (``sharding.api.collective_bytes()``).
"""

from __future__ import annotations

import torch


def _tree_np(tree):
    from repro_torch import tree_map

    return tree_map(lambda t: t.detach().cpu().clone(), tree)


def fixed_grads(whole, to_shards):
    """A stand-in for ``launch.steps.value_and_grad`` whose gradients are
    ``whole`` (numpy), cut by ``to_shards(tree, plan, table)`` under a
    plan: the same gradients on one process and under a mesh."""
    from repro_torch.convert import params_from_numpy

    def value_and_grad(cfg, plan=None, table=None):
        def grads_of(params, batch):
            g = params_from_numpy(whole, device="cpu")
            if plan is not None:
                g = to_shards(g, plan, table)
            zero = torch.zeros(())
            return zero, {"lb_loss": zero}, g
        return grads_of
    return value_and_grad


def _steps(mesh, job):
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import steps as S
    from repro_torch.optim import adamw
    from repro_torch.sharding.params import shard_train_params

    cfg = job["cfg"]
    accum = job.get("accum", 1)
    own = S.value_and_grad
    if "grads" in job:
        S.value_and_grad = fixed_grads(job["grads"], shard_train_params)
    init, step = S.make_train_step(cfg, adamw(**job["opt"]),
                                   accum_steps=accum,
                                   compress_grads=job.get("compress", False),
                                   mesh=mesh)
    state = init(params=params_from_numpy(job["params"], device="cpu"))
    plan, table = S.train_plan(cfg, mesh)
    first = S.batch_to(S.shard_batch(job["batches"][0], mesh, 1), "cpu")
    loss, aux, grads = S.value_and_grad(cfg, plan, table)(state["params"],
                                                          first)
    metrics = []
    for b in job["batches"]:
        state, m = step(state, S.shard_batch(b, mesh, accum))
        metrics.append({k: float(v) for k, v in m.items()})
    S.value_and_grad = own
    out = {"loss": float(loss), "grads": _tree_np(grads),
           "metrics": metrics, "params": _tree_np(state["params"]),
           "mu": _tree_np(state["opt"].mu), "nu": _tree_np(state["opt"].nu),
           "step": int(state["opt"].step)}
    if "ef" in state:
        out["ef"] = _tree_np(state["ef"])
    if "lb_loss" in aux:
        out["lb_loss"] = float(aux["lb_loss"])
    return out


def _init(mesh, job):
    from repro_torch.launch.steps import train_plan
    from repro_torch.models import transformer as T

    plan, _ = train_plan(job["cfg"], mesh)
    return _tree_np(T.init_params(job["cfg"], seed=job["seed"],
                                  device="cpu", plan=plan))


def _raises(mesh, job):
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import steps as S
    from repro_torch.optim import adamw

    init, step = S.make_train_step(job["cfg"], adamw(lr=1e-3), mesh=mesh)
    state = init(params=params_from_numpy(job["params"], device="cpu"))
    try:
        step(state, S.shard_batch(job["batch"], mesh))
    except ValueError as e:
        return str(e)
    return None


def _trainer(mesh, job):
    import pathlib
    import shutil

    import torch.distributed as dist

    from repro_torch.data import make_batches
    from repro_torch.train import Trainer

    if "from_ckpt" in job:
        src = pathlib.Path(job["from_ckpt"])
        dst = pathlib.Path(job["tcfg"].ckpt_dir) / src.name
        if mesh.rank == 0:
            shutil.copytree(src, dst)
        dist.barrier(group=mesh.host_group)
    trainer = Trainer(job["cfg"], job["tcfg"], mesh=mesh)
    batches = make_batches(trainer.host_data(job["data"]), prefetch=0)
    for _ in range(job.get("skip", 0)):   # the batches a resumed run saw
        next(batches)
    trainer.run(batches)
    return [(h["step"], h["loss"]) for h in trainer.history]


def _mesh_mismatch(mesh, job):
    from repro_torch.launch.mesh import make_host_mesh

    try:
        make_host_mesh(model=mesh.model + 1, data=mesh.data, rank=mesh.rank,
                       backend="gloo", store=None, device="cpu")
    except ValueError as e:
        return str(e)
    return None


def _serve(mesh, job):
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import steps as S
    from repro_torch.sharding.params import shard_params, tp_plan

    params = params_from_numpy(job["params"], device="cpu")
    plan = tp_plan(params, job["cfg"], mesh)
    rows = S.shard_batch({"tokens": job["tokens"]}, mesh)
    return S.make_prefill_step(job["cfg"], plan)(
        shard_params(params, plan), S.batch_to(rows, "cpu"))


def _collectives(mesh, job):
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import steps as S
    from repro_torch.optim import adamw
    from repro_torch.sharding import api

    init, step = S.make_train_step(job["cfg"], adamw(**job["opt"]),
                                   mesh=mesh)
    state = init(params=params_from_numpy(job["params"], device="cpu"))
    api.reset_collective_bytes()
    step(state, S.shard_batch(job["batch"], mesh))
    return api.collective_bytes()


_KINDS = {"serve": _serve, "steps": _steps, "init": _init, "raises": _raises,
          "trainer": _trainer, "mesh_mismatch": _mesh_mismatch,
          "collectives": _collectives}


def run_jobs(mesh, jobs: list) -> list:
    torch.set_num_threads(1)
    return [_KINDS[job["kind"]](mesh, job) for job in jobs]
