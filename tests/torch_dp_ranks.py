"""Rank functions for tests/test_torch_dp.py, run by
``ihpr_tpu_torch.parallel.launch.spawn`` in processes of their own. This
module imports torch, numpy and the port only: a rank never imports JAX.

Each function is called as ``fn(rank, world, *args)`` inside an initialized
gloo process group, runs on the CPU with one thread, and returns numpy
arrays and plain values."""

from __future__ import annotations

import dataclasses
import hashlib
import shutil

import numpy as np
import torch
import torch.distributed as dist

from ihpr_tpu_torch.data import datasets, skeletons
from ihpr_tpu_torch.data.augment import finalize_patch
from ihpr_tpu_torch.engine import tester as ttester
from ihpr_tpu_torch.engine.checkpoint import _host_copy
from ihpr_tpu_torch.engine.trainer import Trainer
from ihpr_tpu_torch.models import resnet
from ihpr_tpu_torch.models.pose_net import build_pose_net
from ihpr_tpu_torch.ops import matmul_bn
from ihpr_tpu_torch.ops.loss import joint_location_loss
from ihpr_tpu_torch.parallel import train_step
from ihpr_tpu_torch.parallel.mesh import data_parallel


def run_jobs(rank, world, jobs):
    """Each (name, function name, args) of ``jobs`` in turn: {name: result}."""
    return {name: globals()[fn](rank, world, *args) for name, fn, args in jobs}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def rows(a, rank: int, world: int):
    """This rank's contiguous share of the leading axis."""
    n = a.shape[0] // world
    return a[rank * n : (rank + 1) * n]


def synthetic(n: int) -> datasets.PoseDataset:
    """``n`` synthetic Human36M train samples, as test_torch_checkpoint.py makes them."""
    samples = datasets.make_synthetic(skeletons.H36M, n, seed=0, img_size=200)
    return datasets.PoseDataset("Human36M", skeletons.H36M, samples, is_train=True)


def digest(arrays: dict) -> dict:
    """{key: sha1 of the array's bytes}: bitwise comparisons without sending
    whole states between processes."""
    return {k: hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest() for k, v in arrays.items()}


def state_np(sd: dict) -> dict:
    """A ``TrainState.state_dict()`` with numpy tensors: model, Adam moments
    and counts by parameter index, the schedule's count, the update count."""
    out = {"step": sd["step"], "last_epoch": sd["scheduler"]["last_epoch"]}
    out.update({f"model/{k}": _np(v) for k, v in sd["model"].items()})
    for i, st in sd["optimizer"]["state"].items():
        for k, v in st.items():
            out[f"opt/{i}/{k}"] = _np(torch.as_tensor(v))
    return out


# --- sync-BN: one Bottleneck ---------------------------------------------------------


def bottleneck_ranks(rank, world, x, cot, block_sd, fused_1x1):
    """One fp32 lean Bottleneck in train mode on this rank's rows of ``x``
    (B, C, H, W): the output, dx, the gradients of sum(out * cot) over the
    global batch (this rank's, summed over the ranks) and the running
    statistics; with the count of plain K5 calls."""
    torch.set_num_threads(1)
    cin, e = x.shape[1], x.shape[1] // 4
    block = resnet.Bottleneck(cin, e, 1, torch.float32, "lean", fused_1x1=fused_1x1, dp=data_parallel())
    block.load_state_dict({k: torch.from_numpy(v) for k, v in block_sd.items()})
    block.train()
    calls = [0]
    orig = matmul_bn.plain

    def counting(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)

    matmul_bn.plain = counting
    try:
        xt = torch.from_numpy(rows(x, rank, world)).contiguous(memory_format=torch.channels_last).requires_grad_()
        out = block(xt)
        (out * torch.from_numpy(rows(cot, rank, world))).sum().backward()
    finally:
        matmul_bn.plain = orig
    grads = {}
    for k, p in block.named_parameters():
        g = p.grad.clone()
        dist.all_reduce(g)
        grads[k] = _np(g)
    stats = {k: _np(v) for k, v in block.state_dict().items() if "running" in k}
    return {"out": _np(out), "dx": _np(xt.grad), "grads": grads, "stats": stats, "plain_k5": calls[0]}


# --- the train step --------------------------------------------------------------------


def step_ranks(rank, world, cfg, model_sd, batch, steps):
    """From ``model_sd``: the gradients of the global loss with BN in
    inference mode, through the model's DDP; then ``steps`` train steps on
    this rank's rows of ``batch``: the metrics of each, the gradients of the
    first, and the state after the first and after the last."""
    torch.set_num_threads(1)
    dp = data_parallel(cfg)
    model = build_pose_net(cfg, device="cpu", trainable=True, dp=dp)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in model_sd.items()})
    local = {k: torch.from_numpy(rows(v, rank, world)) for k, v in batch.items()}
    labels = (local["joint_img"], local["joint_vis"], local["joints_have_depth"])

    ddp = train_step._ddp(model, dp)
    model.eval()
    with model.precision():
        joint_location_loss(ddp(finalize_patch(local["patch"], local["color_scale"], cfg.data)), *labels).backward()
    eval_grads = {k: _np(p.grad) for k, p in model.named_parameters()}

    opt, sched = train_step.make_optimizer(model, cfg, 10, dp)
    step = train_step.make_train_step(model, opt, cfg, scheduler=sched, dp=dp)
    metrics, first = [], None
    for i in range(steps):
        metrics.append({k: float(v) for k, v in step(local).items()})
        if i == 0:
            first = {
                "grads": {k: _np(p.grad) for k, p in model.named_parameters()},
                "state": {k: _np(v) for k, v in model.state_dict().items()},
            }
    out = {
        "eval_grads": eval_grads,
        "metrics": metrics,
        "first": first,
        "state": digest({k: _np(v) for k, v in model.state_dict().items()}),
    }
    if rank:  # rank 0's arrays are compared; the others' by digest
        out["eval_grads"], out["first"] = digest(eval_grads), None
    return out


# --- the Trainer ---------------------------------------------------------------------------


def _trainer(cfg, n, **kw):
    trainer = Trainer(cfg, datasets=[synthetic(n)], num_workers=0, device="cpu", **kw)
    writes = [0]
    write = trainer.ckpt._write

    def counting(*a):
        writes[0] += 1
        return write(*a)

    trainer.ckpt._write = counting
    return trainer, writes


def _final_state(trainer) -> dict:
    """``state_np`` of the trainer's state; under ZeRO the optimizer's part
    on rank 0 only (it is consolidated there)."""
    opt = trainer.state.optimizer
    if hasattr(opt, "consolidate_state_dict"):
        opt.consolidate_state_dict(to=0)
        if dist.get_rank() != 0:
            return {f"model/{k}": _np(v) for k, v in trainer.model.state_dict().items()}
    return state_np(_host_copy(trainer.state.state_dict()))


def _train(cfg, n, end_epoch, **kw):
    """Train to ``end_epoch``: the final state (``state_np``), the losses of
    each epoch, the grad_norm of each full-metrics step, the snapshots this
    rank wrote, the resume point."""
    trainer, writes = _trainer(cfg, n, **kw)
    start = (trainer.start_epoch, trainer.resume_skip)
    losses, norms = [], []
    step_fn = trainer.step_fn

    def recording(batch):
        metrics = step_fn(batch)
        norms.append(float(metrics["grad_norm"]))
        return metrics

    trainer.step_fn = recording
    try:
        for end in range(trainer.start_epoch + 1, end_epoch + 1):
            trainer.train(end)
            losses.append([float(x) for x in trainer.losses])
        state = _final_state(trainer)
    finally:
        trainer.close()
    return {"state": state, "losses": losses, "grad_norms": norms, "writes": writes[0], "start": start}


def trainer_ranks(rank, world, cfg, n, dirs, snapshot_1proc):
    """(a) 2 epochs uninterrupted in dirs["a"]; (b) epoch 0 in dirs["b"],
    then ``--continue`` through epoch 1 there; (c) ``--continue`` from the
    1-process snapshot copied into dirs["c"], through epoch 1."""
    torch.set_num_threads(1)
    out = {}
    out["a"] = _train(cfg.replace(output_dir=dirs["a"]), n, 2, rss_limit_mb=0)
    out["b0"] = _train(cfg.replace(output_dir=dirs["b"]), n, 1, rss_limit_mb=0)
    if rank == 0:
        shutil.copytree(f"{dirs['b']}/model_dump/snapshot_0", f"{dirs['b0']}/model_dump/snapshot_0")
    dist.barrier()
    out["b"] = _train(cfg.replace(output_dir=dirs["b"]), n, 2, continue_train=True, rss_limit_mb=0)
    if rank == 0:
        shutil.copytree(snapshot_1proc, f"{dirs['c']}/model_dump/snapshot_0")
    dist.barrier()
    out["c"] = _train(cfg.replace(output_dir=dirs["c"]), n, 2, continue_train=True, rss_limit_mb=0)
    for run in out.values():
        run["state"] = digest(run["state"])
    dist.barrier()
    if rank == 0:
        for key in ("a", "b", "c"):
            shutil.rmtree(dirs[key])
    return out


def resume_disagree_ranks(rank, world, cfg, n, dirs):
    """Each rank resumes from its own directory: the Trainer must refuse."""
    torch.set_num_threads(1)
    try:
        Trainer(cfg.replace(output_dir=dirs[rank]), datasets=[synthetic(n)], num_workers=0,
                device="cpu", continue_train=True, rss_limit_mb=0).close()
    except RuntimeError as exc:
        return str(exc)
    return None


def rss_ranks(rank, world, cfg, n):
    """Rank 0's watchdog trips at every step; rank 1's is off."""
    torch.set_num_threads(1)
    trainer, _ = _trainer(cfg, n, rss_limit_mb=1.0 if rank == 0 else 0, rss_check_interval_steps=1)
    try:
        trainer.train(2)
    finally:
        trainer.close()


def zero_ranks(rank, world, cfg, n, dirs):
    """Two epochs of the same run replicated (dirs["rep"]) and with ZeRO-1
    (dirs["zero"]); then the ZeRO snapshot resumed without ZeRO (its first
    state) for a third epoch."""
    torch.set_num_threads(1)
    zcfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel, shard_opt_state=True))
    out = {"rep": _train(cfg.replace(output_dir=dirs["rep"]), n, 2, rss_limit_mb=0),
           "zero": _train(zcfg.replace(output_dir=dirs["zero"]), n, 2, rss_limit_mb=0)}
    trainer, _ = _trainer(cfg.replace(output_dir=dirs["zero"]), n, continue_train=True, rss_limit_mb=0)
    try:
        out["resumed"] = digest(state_np(_host_copy(trainer.state.state_dict())))
        out["resumed_optimizer"] = type(trainer.state.optimizer).__name__
        trainer.train(3)
        out["resumed_losses"] = [float(x) for x in trainer.losses]
    finally:
        trainer.close()
    rep, zero = out["rep"]["state"], out["zero"]["state"]
    # The largest difference of each tensor, over its largest magnitude (at least 1).
    out["zero_vs_rep"] = {k: float(np.abs(v - rep[k]).max() / max(1.0, np.abs(rep[k]).max()))
                          for k, v in zero.items() if k.startswith(("model/", "opt/"))}
    out["keys"] = (sorted(rep), sorted(zero))
    out["zero"]["state"] = digest(zero)
    del out["rep"]["state"]
    dist.barrier()
    if rank == 0:
        shutil.rmtree(dirs["rep"])
        shutil.rmtree(dirs["zero"])
    return out


# --- the Tester ------------------------------------------------------------------------------


def tester_ranks(rank, world, cfg, model_sd, n):
    """The Tester on this rank's rows: predictions, metrics, and the result
    files this rank wrote."""
    torch.set_num_threads(1)
    model = build_pose_net(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in model_sd.items()})
    written = []
    save, dump = np.save, ttester.json.dump
    ttester.np.save = lambda path, *a, **kw: (written.append(str(path)), save(path, *a, **kw))[1]
    ttester.json.dump = lambda obj, f, *a, **kw: (written.append(f.name), dump(obj, f, *a, **kw))[1]
    try:
        test_set = datasets.build_dataset(cfg.data.testset, "test", cfg, "synthetic", n)
        t = ttester.Tester(cfg, dataset=test_set, state=model, num_workers=0, device="cpu")
        try:
            preds = t.predict_voxels()
            metrics = t.evaluate()
        finally:
            t.close()
    finally:
        ttester.np.save, ttester.json.dump = save, dump
    return {"preds": preds, "metrics": metrics, "written": written}


# --- a snapshot written elsewhere, resumed --------------------------------------------------


def resume_ranks(rank, world, cfg, n):
    """``--continue`` from the snapshot in cfg.output_dir: the resume point,
    the state it starts from and the losses of the next epoch."""
    torch.set_num_threads(1)
    trainer, _ = _trainer(cfg, n, continue_train=True, rss_limit_mb=0)
    try:
        start = (trainer.start_epoch, trainer.resume_skip)
        state = digest(state_np(_host_copy(trainer.state.state_dict())))
        trainer.train(trainer.start_epoch + 1)
        losses = [float(x) for x in trainer.losses]
    finally:
        trainer.close()
    return {"start": start, "state": state, "losses": losses}


def serve_ranks(rank, world, cfg, model_sd, patches, request, stream, snapshot_dir):
    """Data-parallel PoseServers (max_batch 8, partition="data") on the same
    requests on every rank: predict_patches with flip-test on and off, the
    batch each rank's model forwarded, predict and predict_stream, the
    refusals, and a load_server of ``snapshot_dir`` with ``dp``."""
    from ihpr_tpu_torch.engine.server import PoseServer, load_server

    dp = data_parallel()
    sd = {k: torch.from_numpy(v) for k, v in model_sd.items()}
    out = {}
    for flip in (True, False):
        srv = PoseServer(cfg, sd, max_batch=8, flip_test=flip, device="cpu", dp=dp, partition="data")
        coords, forwarded = srv.model.coords, []
        srv.model.coords = lambda x: (forwarded.append(tuple(x.shape)), coords(x))[1]
        out[f"patches_{flip}"] = srv.predict_patches(patches)
        out[f"forwarded_{flip}"] = list(forwarded)
    out["predict"] = [r.coords_img for r in srv.predict(*request)]
    out["stream"] = [[r.coords_img for r in res] for res in srv.predict_stream(stream)]
    out["loaded"] = load_server(cfg, snapshot_dir, max_batch=8, flip_test=False, device="cpu", dp=dp,
                                partition="data").predict_patches(patches)
    for name, kw, err in (("odd", dict(max_batch=7, partition="data"), ValueError),
                          ("spatial", dict(max_batch=8), NotImplementedError)):
        try:
            PoseServer(cfg, sd, device="cpu", dp=dp, **kw)
            out[name] = None
        except err as e:
            out[name] = str(e)
    return out


def canvas_ranks(rank, world, cfg, batch, aug_key):
    """This rank's rows of a canvas batch through ``train_step.patch_batch``
    with augmentation: the draws are the global batch's, sliced."""
    pb = train_step.patch_batch({k: torch.from_numpy(rows(v, rank, world)) for k, v in batch.items()}, cfg,
                                skeletons.H36M.flip_permutation(), train=True, aug_key=aug_key,
                                dp=data_parallel())
    return {"image": _np(pb.image), "joint_img": _np(pb.joint_img), "joint_vis": _np(pb.joint_vis)}
