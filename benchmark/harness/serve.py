"""``serve_stream`` cells: one client's frames, each with its people's boxes,
handed to ``PoseServer.predict_stream`` in a closed loop: the client gives
the server its next request whenever the server asks for one, so the
server's own pace sets the load.

Set-up makes the frames, the benchmark's weights (``serving_state``: each
residual branch's last BatchNorm scale small, BatchNorm statistics
calibrated and the head's logits spread as a trained model's, by the
reference on a batch of crops), the server (``PoseServer(cfg, state,
max_batch, flip_test=True)``), and warms it on requests of its own until
their pace is steady (``common.warm_until_steady``).

``serve_img_per_s`` counts each person of each request answered before the
window closed, over the window (padding not counted).

Once the window is over and the server is freed, the reference answers a
sample of the answered requests drawn from the seed, with the request of
most people in it, from the same frames and boxes; the check is the widest
gap of any joint, in heatmap voxels (frame pixels over the box's pixels per
voxel, millimetres over the millimetres per voxel).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.harness import common, traffic, weights
from benchmark.harness.cells import Cell, port_config
from benchmark.reference import pose_net as ref_net
from benchmark.reference import serve as ref_serve
from benchmark.reference import train as ref_train


def _calibration(sizes, t, seed, frames_dev) -> torch.Tensor:
    """Normalized crops of the first people of a request stream of its own."""
    in_h, in_w = sizes["input_shape"]
    gen = traffic.requests(t, seed, common.SAMPLE)
    people = []
    while len(people) < t["calibration_people"]:
        idx, boxes = next(gen)
        fh, fw = frames_dev.shape[1:3]
        for box in boxes:
            fixed = ref_serve.fix_box(box, fw, fh, in_w / in_h, sizes["bbox_margin"])
            aff = torch.as_tensor(ref_serve.crop_affine(fixed, in_h, in_w)[None], dtype=torch.float32)
            people.append(ref_serve.crops(frames_dev[idx], aff, in_h, in_w))
    patches = torch.cat(people[: t["calibration_people"]])
    ones = torch.ones((len(patches), 3), device=patches.device)
    return ref_net.normalize(patches, ones, sizes)


def serving_state(sizes, t, seed, device, frames_dev) -> Dict[str, torch.Tensor]:
    """The served weights: the configuration's draw with each residual
    branch's last BatchNorm scale set to ``residual_gamma`` (a trained
    ResNet's branches are small beside the identity), then calibrated."""
    state = weights.draw(sizes, seed, device)
    for name in state:
        if name.endswith(".bn3.weight"):
            state[name] = torch.full_like(state[name], t["residual_gamma"])
    return ref_train.calibrate(sizes, state, _calibration(sizes, t, seed, frames_dev), t["logit_std"])


def run(cell: Cell, seed: int, seconds: float, tracer, device, setup_t0: float) -> Dict:
    from ihpr_tpu_torch.engine.server import PoseServer

    sizes, t = cell.sizes, cell.traffic
    cfg = port_config(sizes)
    frames_dev = traffic.frames(t, seed, device)
    frames = list(frames_dev.cpu().numpy())
    state = serving_state(sizes, t, seed, device, frames_dev)
    server = PoseServer(cfg, state, max_batch=t["max_batch"], flip_test=True, device=device)
    del frames_dev
    warm = traffic.requests(t, seed, common.SAMPLE)

    def warm_group():
        reqs = [next(warm) for _ in range(t["warmup_group"])]
        for _ in server.predict_stream(([frames[i]] * len(b), b) for i, b in reqs):
            pass

    common.warm_until_steady(warm_group, device, t["warmup"])
    schedule = traffic.requests(t, seed)
    offered, done, traced = [], [], {}
    common.sync(device)
    setup_s = common.now() - setup_t0
    t0 = common.now()
    t_end = t0 + seconds

    def client():
        while True:
            clock = common.now()
            if tracer is not None and not traced and clock - t0 >= t["trace_after_s"]:
                tracer.start()
                traced.update(start=clock, first=len(done))
            if clock >= t_end:
                return
            idx, boxes = next(schedule)
            offered.append({"frame": idx, "boxes": boxes})
            yield [frames[idx]] * len(boxes), boxes

    for results in server.predict_stream(client(), depth=t["depth"]):
        done.append((common.now(), results))
        if "start" in traced and "last" not in traced and done[-1][0] - traced["start"] >= t["trace_seconds"]:
            tracer.stop()
            traced["last"] = len(done)
    if "start" in traced and "last" not in traced:
        tracer.stop()
        traced["last"] = len(done)
    common.sync(device)
    info = common.device_info(device)
    del server
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    answered = sum(len(r) for at, r in done if at <= t_end)
    missing = sum(abs(len(r) - len(o["boxes"])) for o, (_, r) in zip(offered, done)) + len(offered) - len(done)
    gap = _check(sizes, t, seed, device, state, frames, offered, done)
    counters = {"dispatch_images": 2 * t["max_batch"]}
    if traced:
        counters["people_traced"] = sum(len(r) for _, r in done[traced["first"]:traced["last"]])
    return {
        "setup_s": setup_s, "window_s": seconds, "attempted": len(offered), "failed": int(missing),
        "e2e": {"serve_img_per_s": answered / seconds},
        "numbers": {"coord_gap": gap, "missing_answers": float(missing)}, "counters": counters, "device": info,
    }


def _check(sizes, t, seed, device, state, frames, offered, done) -> float:
    """The widest gap, in voxels, between the served joints and the
    reference's, over a sample of the answered requests."""
    rng = common.host_rng(seed, common.SAMPLE)
    n = min(len(done), len(offered))
    if n == 0:
        return float("inf")
    most = max(range(n), key=lambda i: len(offered[i]["boxes"]))
    pick = sorted({most, *rng.choice(n, size=min(n, t["check_requests"]) - 1, replace=False).tolist()})
    frame_ids = sorted({offered[i]["frame"] for i in pick})
    local = {f: k for k, f in enumerate(frame_ids)}
    frames_dev = [torch.from_numpy(frames[f]).to(device) for f in frame_ids]
    reqs = [(local[offered[i]["frame"]], offered[i]["boxes"]) for i in pick]
    ref = ref_serve.answer(sizes, state, frames_dev, reqs)
    return served_gap(sizes, [done[i][1] for i in pick], ref)


def served_gap(sizes, served, ref) -> float:
    """Widest |served - reference| over joints, in voxels; inf where a
    request's answers are missing. ``served``: each request's PoseResults."""
    return answers_gap(sizes, [[np.asarray(r.coords_img, np.float64) for r in res] for res in served], ref)


def answers_gap(sizes, answers, ref) -> float:
    """Widest gap of ``answers`` (each request's (J, 3) frame coords per
    person) from the reference's (``reference.serve.answer``), in voxels."""
    mm_per_voxel = sizes["bbox_3d_shape"][0] / sizes["depth_dim"]
    worst = 0.0
    for people, r in zip(answers, ref):
        if len(people) != len(r["coords"]):
            return float("inf")
        for coords, expected, ppv in zip(people, r["coords"], r["px_per_voxel"]):
            d = np.abs(coords - expected)
            worst = max(worst, float(d[:, :2].max() / ppv), float(d[:, 2].max() / mm_per_voxel))
    return worst
