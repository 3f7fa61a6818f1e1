"""Training under a ``("data", "model")`` mesh against the JAX reference and
the port's single-process step, on the CPU.

One 4-rank world (``launch.mesh.run_ranks``, gloo, one thread a rank) at
``data 2 x model 2`` runs every job of ``tests/_torch_train_mesh_worker.py``
while this process runs the reference's and the port's single-process
steps on the same numpy params (``tests/_torch_numpy_params.py``) at
``.reduced()`` widths, fed the same global batches (each data rank takes
its rows, ``launch.steps.shard_batch``), with a ``loss_mask`` that varies
by row:

* gpt2-medium, granite-moe-1b-a400m (routing groups of 16 tokens, so a
  rank holds two of them) and mamba2-2.7b: the first batch's loss
  against the reference's ``jax.value_and_grad`` and the port's (1e-5
  relative), every gradient leaf put back together from the ranks'
  shards against both (``tests/test_torch_train.py``'s FP32 limits),
  then 3 AdamW steps with clipping active: each step's metrics and the
  stepped state (masters, both moments) put back together against the
  port's single-process steps at ``test_torch_train.py``'s limits;
* ``accum_steps=2`` (gpt2-medium) the same way, and ``compress_grads``
  fed the same gradients on both sides (the first batch's, every step,
  as ``tests/test_torch_train.py`` feeds both packages: an int8 level
  flips wherever two orders of summation part a value sitting within
  rounding of a half level) at that file's compressed-step limits: the
  scale is each whole leaf's, the error feedback kept per shard;
* a data split that would cut an MoE routing group raises, as does a
  mesh whose ``data x model`` is not the world's size;
* the serving steps at ``data > 1`` take their own rows: each rank's
  prefill logits are its rows of the single-process step's;
* a ``Trainer(mesh=)`` at ``accum_steps=2`` repeats one process's
  Trainer on the data ranks' global batch (the synthetic stream's
  ``loss_mask`` masks each row's EOS labels; short documents make their
  counts differ by row);
* a checkpoint saved by a ``Trainer(mesh=)`` resumed by one process
  repeats the mesh run's losses, and one saved by one process resumed
  under the mesh repeats its losses (1e-5 relative: the two runs sum in
  other orders); resumed under the mesh again, it repeats the mesh
  run's losses exactly;
* the dry run (``launch.dryrun.count_train_step`` on meta tensors at a
  shape-only data 2 x model 2 gloo mesh) counts, for every rank, the
  collectives the world's step issues, by kind, axis, operand bytes and
  number (gpt2-medium in bf16 under remat "full", granite-moe).

``init_params(plan=)``, ``train_shardings`` and the placements need no
ranks: ``tests/test_torch_shapes.py``.
"""

import concurrent.futures
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train_mesh_worker as W
from _torch_numpy_params import numpy_params
from repro.configs import get_config as jget_config
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import DataConfig, make_batches
from repro_torch.launch import steps as TS
from repro_torch.launch.dryrun import count_train_step
from repro_torch.launch.mesh import Mesh, run_ranks, shape_mesh
from repro_torch.optim import adamw
from repro_torch.optim.adamw import leaves_with_paths
from repro_torch.sharding.params import unshard_leaf
from repro_torch.train import Trainer, TrainerConfig

DATA, MODEL = 2, 2
WORLD = DATA * MODEL
LOSS = dict(rtol=1e-5, atol=0.0)
FP32 = dict(rtol=2e-4, atol=2e-5)      # tests/test_torch_train.py
NU = dict(rtol=2e-4, atol=1e-9)
SAME_GRADS = dict(rtol=1e-6, atol=1e-9)  # test_torch_train.py, compression
WORLD_TIMEOUT_S = 300
# clip_norm below every step's norm: clipping is active.  AdamW's step
# m / (sqrt(v) + eps) turns a gradient within rounding of 0 into about
# a whole lr at the default eps (1e-8), so two orders of summation may
# part by ~lr in such an element (tests/test_torch_train.py compares
# stepped params after a plain gradient step for that reason); eps 1e-4
# keeps every element's step a smooth function of its gradient
OPT = dict(lr=1e-3, clip_norm=0.5, eps=1e-4)
ARCHS = ("gpt2-medium", "granite-moe-1b-a400m", "mamba2-2.7b")
STEP_JOBS = {"gpt2-medium": {}, "granite-moe-1b-a400m": {},
             "mamba2-2.7b": {}, "accum2": {"accum": 2},
             "compress": {"compress": True}}
TRAIN_STEPS, SAVED_AT = 6, 3
ACCUM_STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, group_size=16):
    jc, tc = jget_config(arch).reduced(), tget_config(arch).reduced()
    if tc.moe is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, group_size=group_size))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, group_size=group_size))
    return jc, tc


def _batches(vocab, n=3, B=4, S=16, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:],
                    "loss_mask": (rng.random((B, S)) > 0.3)
                    .astype(np.float32)})
    return out


# the dry run's collectives against the world's, on each config's params
# and first batch of its steps job
DRY_ARCHS = ("gpt2-medium", "granite-moe-1b-a400m")


def _dry_cfg(arch):
    tc = _pair(arch)[1]
    if arch == "gpt2-medium":      # bf16 compute under remat "full"
        tc = dataclasses.replace(tc, dtype="bfloat16", remat="full")
    return tc


def _step_job(name):
    arch = name if name in ARCHS else "gpt2-medium"
    jc, tc = _pair(arch)
    return {"kind": "steps", "cfg": tc, "params": numpy_params(jc, 3),
            "batches": _batches(tc.vocab), "opt": OPT, **STEP_JOBS[name]}


def _trainer_cfg(ckpt_dir):
    return TrainerConfig(steps=TRAIN_STEPS, peak_lr=3e-3, warmup=2,
                         log_every=0, ckpt_every=SAVED_AT,
                         ckpt_dir=str(ckpt_dir), keep_last=2)


def _accum_cfg():
    return TrainerConfig(steps=ACCUM_STEPS, peak_lr=3e-3, warmup=2,
                         log_every=0, ckpt_every=0, accum_steps=2)


def _data(tc):
    return DataConfig(vocab=tc.vocab, seq_len=16, global_batch=4, seed=5)


def _accum_data(tc):
    """Short documents: several EOS labels a row, masked, in counts that
    differ by row."""
    return dataclasses.replace(_data(tc), template_len=4)


def _global_batches(tc, skip=0, dcfg=None):
    """The global batch the mesh's data ranks read together: each host's
    stream (``Trainer.host_data``) of ``dcfg`` (``_data``), rows in
    data-rank order, from the ``skip``-th batch (a resumed run's next)."""
    dcfg = dcfg or _data(tc)
    hosts = [make_batches(dataclasses.replace(dcfg, host_count=DATA,
                                              host_index=d), prefetch=0)
             for d in range(DATA)]
    for _ in range(skip):
        for h in hosts:
            next(h)
    while True:
        parts = [next(h) for h in hosts]
        yield {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _reference(arch, job):
    jc = _pair(arch)[0]
    b = {k: jnp.asarray(v) for k, v in job["batches"][0].items()}

    def loss_of(p):
        return JT.loss_fn(JS._compute_cast(p, jc), b, jc)

    params = jax.tree_util.tree_map(jnp.asarray, job["params"])
    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        params)
    return float(loss), float(aux.get("lb_loss", 0.0)), grads


def _single(job):
    """The port's single-process run of a steps job."""
    tc = job["cfg"]
    own = TS.value_and_grad
    if "grads" in job:
        TS.value_and_grad = W.fixed_grads(job["grads"], None)
    try:
        return _single_run(job, tc)
    finally:
        TS.value_and_grad = own


def _single_run(job, tc):
    init, step = TS.make_train_step(tc, adamw(**job["opt"]),
                                    accum_steps=job.get("accum", 1),
                                    compress_grads=job.get("compress", False))
    state = init(params=params_from_numpy(job["params"], device="cpu"))
    loss, _, grads = TS.value_and_grad(tc)(
        state["params"], TS.batch_to(job["batches"][0], "cpu"))
    metrics = []
    for b in job["batches"]:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"loss": float(loss), "grads": grads, "metrics": metrics,
            "state": state}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job's ranks' results, the reference's and the single-process
    runs; the world runs while this process runs the rest."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    jobs = {n: _step_job(n) for n in STEP_JOBS}
    _, tc = _pair("gpt2-medium")
    c = jobs["compress"]
    _, _, g = TS.value_and_grad(tc)(
        params_from_numpy(c["params"], device="cpu"),
        TS.batch_to(c["batches"][0], "cpu"))
    c["grads"] = _numpy(g)
    # one process trains first; the mesh resumes its step-3 checkpoint
    single = Trainer(tc, _trainer_cfg(tmp / "single"), device="cpu")
    single.run(_global_batches(tc))
    shutil.copytree(tmp / "single" / f"step_{SAVED_AT:08d}",
                    tmp / "from_single" / f"step_{SAVED_AT:08d}")
    _, cut = _pair("granite-moe-1b-a400m", group_size=64)
    jobs.update(
        cut={"kind": "raises", "cfg": cut,
             "params": numpy_params(_pair("granite-moe-1b-a400m")[0], 3),
             "batch": _batches(cut.vocab, n=1)[0]},
        mesh_trainer={"kind": "trainer", "cfg": tc, "data": _data(tc),
                      "tcfg": _trainer_cfg(tmp / "mesh")},
        mesh_resumes={"kind": "trainer", "cfg": tc, "data": _data(tc),
                      "tcfg": _trainer_cfg(tmp / "from_single"),
                      "skip": SAVED_AT},
        # after mesh_trainer, in the ranks' job order
        mesh_resumes_mesh={"kind": "trainer", "cfg": tc, "data": _data(tc),
                           "tcfg": _trainer_cfg(tmp / "mesh_again"),
                           "from_ckpt": str(tmp / "mesh"
                                            / f"step_{SAVED_AT:08d}"),
                           "skip": SAVED_AT},
        mesh_accum={"kind": "trainer", "cfg": tc, "data": _accum_data(tc),
                    "tcfg": _accum_cfg()},
        mismatch={"kind": "mesh_mismatch"},
        serve={"kind": "serve", "cfg": tc,
               "params": jobs["gpt2-medium"]["params"],
               "tokens": jobs["gpt2-medium"]["batches"][0]["tokens"]})
    for arch in DRY_ARCHS:
        jobs[f"collectives_{arch}"] = {
            "kind": "collectives", "cfg": _dry_cfg(arch), "opt": OPT,
            "params": jobs[arch]["params"],
            "batch": jobs[arch]["batches"][0]}
    names = list(jobs)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(run_ranks, W.run_jobs, WORLD, backend="gloo",
                            device="cpu", data=DATA,
                            args=([jobs[n] for n in names],),
                            timeout_s=WORLD_TIMEOUT_S, workdir=tmp)
        ref = {n: _reference(n, jobs[n]) for n in ARCHS}
        one = {n: _single(jobs[n]) for n in STEP_JOBS}
        single_accum = Trainer(tc, _accum_cfg(), device="cpu")
        single_accum.run(_global_batches(tc, dcfg=_accum_data(tc)))
        ranks = world.result()
    out = {n: [ranks[r][i] for r in range(WORLD)]
           for i, n in enumerate(names)}
    return jobs, out, ref, one, {"ckpt": single, "accum": single_accum}, tmp


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _table(cfg):
    return TS.train_plan(cfg, Mesh(model=MODEL, data=DATA, device="cpu"))


def _whole(results, key, like, cfg):
    """{path: whole leaf} put back together from every rank's shards."""
    plan, table = _table(cfg)
    out = {}
    for path, _ in leaves_with_paths(like):
        parts = []
        for res in results:
            t = res[key]
            for k in path:
                t = t[k]
            parts.append(t)
        out[path] = unshard_leaf(parts, table["/".join(path)], plan)
    return out


def _assert_close(whole: dict, want, **tol):
    for path, leaf in leaves_with_paths(want):
        got = whole[path]
        assert got.shape == leaf.shape, path
        np.testing.assert_allclose(got.numpy(), np.asarray(
            leaf.detach() if isinstance(leaf, torch.Tensor) else leaf,
            dtype=np.float32), err_msg=str(path), **tol)


def _ref_tree(grads) -> dict:
    """The reference's gradient pytree as nested dicts of numpy."""
    if isinstance(grads, dict):
        return {k: _ref_tree(v) for k, v in grads.items()}
    return np.asarray(grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference_and_one_process(runs, arch):
    jobs, out, ref, one, _, _ = runs
    rloss, rlb, rgrads = ref[arch]
    for res in out[arch]:                # the whole batch's loss everywhere
        np.testing.assert_allclose(res["loss"], rloss, **LOSS)
        np.testing.assert_allclose(res["loss"], one[arch]["loss"], **LOSS)
        if jobs[arch]["cfg"].moe is not None:
            assert res["lb_loss"] > 0
            np.testing.assert_allclose(res["lb_loss"], rlb, **LOSS)
    whole = _whole(out[arch], "grads", one[arch]["grads"], jobs[arch]["cfg"])
    _assert_close(whole, one[arch]["grads"], **FP32)
    ref_tree = _ref_tree(rgrads)
    flat = {p: g for p, g in leaves_with_paths(ref_tree)}
    assert sorted(flat) == sorted(whole)
    _assert_close(whole, ref_tree, **FP32)


@pytest.mark.parametrize("name", list(STEP_JOBS))
def test_steps_match_one_process(runs, name):
    """Three steps, clipping active: metrics and the stepped state (the
    masters and both moments, and the error feedback) put back together
    from the shards."""
    jobs, out, _, one, _, _ = runs
    cfg = jobs[name]["cfg"]
    for res in out[name]:
        assert res["step"] == len(jobs[name]["batches"])
        for got, want in zip(res["metrics"], one[name]["metrics"]):
            assert sorted(got) == sorted(want)
            assert want["grad_norm"] > OPT["clip_norm"]
            for k in want:
                np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                           **LOSS)
    st = one[name]["state"]
    same = "grads" in jobs[name]
    tol, nu = (SAME_GRADS, SAME_GRADS) if same else (FP32, NU)
    _assert_close(_whole(out[name], "params", st["params"], cfg),
                  st["params"], **tol)
    _assert_close(_whole(out[name], "mu", st["opt"].mu, cfg),
                  st["opt"].mu, **tol)
    _assert_close(_whole(out[name], "nu", st["opt"].nu, cfg),
                  st["opt"].nu, **nu)
    assert ("ef" in st) == same
    if same:
        _assert_close(_whole(out[name], "ef", st["ef"], cfg), st["ef"],
                      **tol)


def test_shards_are_the_ranks_parts(runs):
    """Each rank's stepped masters have its placement's shard shape, and
    the two model ranks of a data index hold different parts."""
    jobs, out, _, _, _, _ = runs
    plan, table = _table(jobs["gpt2-medium"]["cfg"])
    for res in out["gpt2-medium"]:
        for path, leaf in leaves_with_paths(res["params"]):
            assert tuple(leaf.shape) == table["/".join(path)].shard, path
    a = out["gpt2-medium"][0]["params"]["embedding"]["table"]
    b = out["gpt2-medium"][1]["params"]["embedding"]["table"]
    assert not torch.equal(a, b)


def test_a_split_that_cuts_a_routing_group_raises(runs):
    _, out, _, _, _, _ = runs
    for msg in out["cut"]:
        assert msg is not None and "cuts the MoE routing groups" in msg


def test_a_mesh_of_another_size_than_the_world_raises(runs):
    _, out, _, _, _, _ = runs
    for msg in out["mismatch"]:
        assert msg is not None and "process group" in msg


def test_serving_steps_take_their_own_rows(runs):
    jobs, out, _, _, _, _ = runs
    job = jobs["serve"]
    whole = TS.make_prefill_step(job["cfg"])(
        params_from_numpy(job["params"], device="cpu"),
        {"tokens": torch.from_numpy(job["tokens"])})
    rows = whole.shape[0] // DATA
    for r, logits in enumerate(out["serve"]):
        d = r // MODEL
        np.testing.assert_allclose(logits.numpy(),
                                   whole[d * rows:(d + 1) * rows].numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_mesh_checkpoint_resumes_on_one_process(runs):
    """The mesh Trainer's step-3 checkpoint (whole leaves, written by rank
    0) resumed by one process: its steps 3-5 repeat the mesh run's."""
    _, out, _, _, _, tmp = runs
    mesh_losses = out["mesh_trainer"]
    for other in mesh_losses[1:]:
        assert other == mesh_losses[0]
    _, tc = _pair("gpt2-medium")
    src = tmp / "mesh" / f"step_{SAVED_AT:08d}"
    shutil.copytree(src, tmp / "to_single" / src.name)
    resumed = Trainer(tc, _trainer_cfg(tmp / "to_single"), device="cpu")
    resumed.run(_global_batches(tc, skip=SAVED_AT))
    got = [(h["step"], h["loss"]) for h in resumed.history]
    want = mesh_losses[0][SAVED_AT:]
    assert [s for s, _ in got] == [s for s, _ in want] == [3, 4, 5]
    np.testing.assert_allclose([l for _, l in got], [l for _, l in want],
                               **LOSS)


def test_one_process_checkpoint_resumes_under_the_mesh(runs):
    _, out, _, _, single, _ = runs
    want = [(h["step"], h["loss"])
            for h in single["ckpt"].history][SAVED_AT:]
    for got in out["mesh_resumes"]:
        assert [s for s, _ in got] == [s for s, _ in want]
        np.testing.assert_allclose([l for _, l in got], [l for _, l in want],
                                   **LOSS)


def test_restore_refuses_a_missing_leaf(tmp_path):
    """A leaf the manifest lacks is an error, whole or sharded, never a
    fresh draw in its place."""
    save_checkpoint(tmp_path, 1, {"params": {"a": torch.ones(4)}})
    like = {"params": {"a": torch.ones(4), "b": torch.ones(2)}}
    with pytest.raises(KeyError, match="missing"):
        restore_checkpoint(tmp_path, 1, like)
    with pytest.raises(KeyError, match="missing"):
        restore_checkpoint(tmp_path, 1, like,
                           shard=lambda pid, t: t.narrow(0, 0, 2))


def test_mesh_checkpoint_resumes_under_the_mesh_exactly(runs):
    """The mesh Trainer's step-3 checkpoint resumed by the same mesh: its
    steps 3-5 are the uninterrupted run's, bitwise (every restored shard
    is the one saved, and the data stream picks up where it was)."""
    _, out, _, _, _, _ = runs
    want = out["mesh_trainer"][0][SAVED_AT:]
    assert [s for s, _ in want] == [3, 4, 5]
    for got in out["mesh_resumes_mesh"]:
        assert got == want


def test_trainer_accumulates_the_global_microbatches(runs):
    """At ``accum_steps=2`` the mesh Trainer's microbatch ``i`` is the
    global batch's ``i``-th block, as on one process: the losses agree
    where the rows' loss masks differ."""
    _, out, _, _, single, _ = runs
    want = [(h["step"], h["loss"]) for h in single["accum"].history]
    assert [s for s, _ in want] == list(range(ACCUM_STEPS))
    for got in out["mesh_accum"]:
        assert [s for s, _ in got] == [s for s, _ in want]
        np.testing.assert_allclose([l for _, l in got], [l for _, l in want],
                                   **LOSS)


@pytest.mark.parametrize("arch", DRY_ARCHS)
def test_dry_run_counts_the_worlds_collectives(runs, arch):
    jobs, out = runs[0], runs[1]
    job = jobs[f"collectives_{arch}"]
    for rank, got in enumerate(out[f"collectives_{arch}"]):
        dry = count_train_step(job["cfg"], shape_mesh(DATA, MODEL, rank=rank,
                                                      backend="gloo"),
                               job["batch"], adamw(**job["opt"]))
        assert dry.collectives == got
        assert {axis for _, axis, _ in got} == {"data", "model"}
