"""Tester: the eval loop with flip-test and the datasets' metrics,
counterpart of ``ihpr_tpu.engine.tester``.

Reference: ``common/base.py:Tester`` and ``main/test.py`` (no-grad loop,
flip-test, predictions gathered, ``db.evaluate``) and the per-dataset
evaluate (``Human36M.evaluate``: warp back, pixel2cam, root-align,
per-action MPJPE). The model comes from the caller or from a snapshot in
``cfg.output_dir``; the log goes to ``{output_dir}/log/test_logs.txt``.
``evaluate(vis=True)`` also writes the reference's overlays of the first
``vis_count`` predictions to ``{output_dir}/vis/pred_{i}.jpg``
(``utils/vis.py``), each frame read through ``data/jpeg.py`` on the
Tester's device (or rendered, for a synthetic sample) and written through
``jpeg.encode``.

Data-parallel (an initialized ``torch.distributed`` group), each rank
scores its rows of each global batch (``eval.batch_size_per_device`` times
the world size), and the ranks' coords and sample indices are gathered in
rank order before they are scattered, so every rank holds every prediction
and returns the metrics; only rank 0 writes the result files. On a D x S
grid (``cfg.parallel.spatial_axis_size``) the batch and the gather run
over the data axis, so each sample is scored once, and the S peers of a
data index each run their rows of it (the model is built on the grid).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from ihpr_tpu_torch.config import Config
from ihpr_tpu_torch.data import geometry
from ihpr_tpu_torch.data.datasets import (
    PoseDataset,
    build_dataset,
    evaluate_h36m,
    evaluate_mpii_pckh,
    evaluate_mscoco,
)
from ihpr_tpu_torch.data.pipeline import BatchLoader, prefetch_to_device
from ihpr_tpu_torch.data.warp import gen_trans_np
from ihpr_tpu_torch.engine.checkpoint import load_snapshot
from ihpr_tpu_torch.engine.logger import colorlogger
from ihpr_tpu_torch.models.pose_net import PoseNet, build_pose_net, inference_copy, on_grid
from ihpr_tpu_torch.parallel.mesh import all_gather_rows, comm_device, data_parallel
from ihpr_tpu_torch.parallel.train_step import TrainState, make_eval_step


def metrics_from_voxel_preds(
    cfg: Config, loader: BatchLoader, dataset: PoseDataset, preds_voxel: np.ndarray
):
    """(N, J, 3) voxel predictions in loader.index order -> (metrics,
    preds_img, samples, preds_cam): warp back to original-image pixels and
    absolute mm, then the dataset's metric (reference Human36M.evaluate /
    MPII.evaluate)."""
    name = dataset.name
    in_shape, out_shape = cfg.data.input_shape, cfg.data.output_shape
    samples = [dataset.samples[si] for _, si, _ in loader.index]
    bboxes = np.stack([b for _, _, b in loader.index]).astype(np.float32)
    invs = gen_trans_np(
        bboxes[:, 0] + bboxes[:, 2] / 2, bboxes[:, 1] + bboxes[:, 3] / 2,
        bboxes[:, 2], bboxes[:, 3], in_shape[1], in_shape[0], 1.0, 0.0, inv=True,
    )
    preds_img = np.zeros_like(preds_voxel)
    for i, (sample, inv) in enumerate(zip(samples, invs)):
        preds_img[i] = geometry.warp_coord_to_original(
            preds_voxel[i], inv, out_shape, in_shape, cfg.data.depth_dim,
            cfg.data.bbox_3d_shape[0], sample["root_z"],
        )

    preds_cam = None
    if name == "Human36M":
        preds_cam = np.stack(
            [geometry.pixel2cam(p, s["f"], s["c"]) for p, s in zip(preds_img, samples)]
        )
        metrics = evaluate_h36m(preds_cam, samples, cfg.eval.protocol)
    elif name == "MPII":
        metrics = evaluate_mpii_pckh(preds_img, samples)
    elif name == "MSCOCO":
        metrics = evaluate_mscoco(preds_img, samples)
    else:
        raise KeyError(name)
    return metrics, preds_img, samples, preds_cam


class Tester:
    def __init__(
        self,
        cfg: Config,
        test_epoch: Optional[int] = None,
        data_root: Optional[str] = None,
        dataset: Optional[PoseDataset] = None,
        state: Union[TrainState, PoseNet, None] = None,
        num_workers: int = 8,
        synthetic_size: int = 128,
        device="cuda",
    ):
        """``dataset``: the test set, or None to build ``cfg.data.testset``
        from ``data_root`` (``datasets.build_dataset``; ``synthetic_size``
        samples of a synthetic root). ``state``: the trainer's ``TrainState`` or a ``PoseNet``,
        or None to load snapshot ``test_epoch`` (default: the latest) from
        ``cfg.output_dir``. The Tester evaluates a frozen copy
        (``pose_net.inference_copy``) on ``device``."""
        self.cfg = cfg
        self.device = torch.device(device)
        self.dp = data_parallel(cfg)
        self.logger = colorlogger(f"{cfg.output_dir}/log", "test_logs.txt")
        if dataset is None:
            dataset = build_dataset(cfg.data.testset, "test", cfg, data_root, synthetic_size)
        self.dataset = dataset
        data = self.dp.data_axis
        self.loader = BatchLoader(
            [dataset], cfg, cfg.eval.batch_size_per_device * data.world, train=False,
            num_workers=num_workers, rank=data.rank, world=data.world, device=self.device,
        )
        if state is None:
            state_dict, epoch = load_snapshot(cfg.output_dir, test_epoch)
            model = build_pose_net(cfg, dataset.joint_num, device=self.device, dp=self.dp,
                                   state_dict=state_dict["model"])
            self.logger.info("loaded snapshot_%d", epoch)
        else:
            model = state.model if isinstance(state, TrainState) else state
        if model.joint_num != dataset.joint_num:
            raise ValueError(f"model has {model.joint_num} joints, {dataset.name} has {dataset.joint_num}")
        self.model = inference_copy(on_grid(model, cfg, self.dp, self.device)).to(self.device)
        self.eval_step = make_eval_step(self.model, cfg)

    def close(self):
        self.loader.close()

    def predict_voxels(self) -> np.ndarray:
        """(N, J, 3) voxel coords of the whole test set, in loader.index
        order. Rows are scattered by the loader's ``sample_idx``, so the
        padding of the last batch lands on the sample it repeats. On a
        process group every rank all-gathers the data axis's coords and
        indices first (data index d holds rows [d*B/D, (d+1)*B/D) of each
        global batch, so the two gathers line up row for row; spatial peers
        hold the same coords).
        ``loader_wait_s``: host seconds spent waiting for the next batch
        (warp and copy), while the device has no eval work queued."""
        n = len(self.loader.index)
        out = np.zeros((n, self.dataset.joint_num, 3), np.float32)
        seen = np.zeros(n, bool)
        batches = prefetch_to_device(self.loader.epoch(), self.device)
        self.loader_wait_s = 0.0
        while True:
            t0 = time.perf_counter()
            item = next(batches, None)
            self.loader_wait_s += time.perf_counter() - t0
            if item is None:
                break
            batch, sample_idx = item
            coords, _, _ = self.eval_step(batch)
            data = self.dp.data_axis
            if data.group is not None:
                coords = all_gather_rows(coords, data)
                idx = torch.from_numpy(sample_idx).to(comm_device(data))
                sample_idx = all_gather_rows(idx, data).cpu().numpy()
            out[sample_idx] = coords.cpu().numpy()
            seen[sample_idx] = True
        if not seen.all():
            raise AssertionError(f"{int((~seen).sum())} test samples got no prediction")
        return out

    def evaluate(self, vis: bool = False, vis_count: int = 8) -> Dict[str, float]:
        """Predict, score, and write ``result/metrics_<name>.json``,
        ``result/preds_<name>.npy`` (original-image px and mm) and, with
        ``cfg.eval.dump_artifacts``, the reference's result files under
        ``cfg.output_dir``; with ``vis``, the overlays of the first
        ``vis_count`` samples (``write_overlays``). Every rank returns the
        metrics; only rank 0 writes (JAX: process 0)."""
        cfg = self.cfg
        name = self.dataset.name
        metrics, preds_img, samples, preds_cam = metrics_from_voxel_preds(
            cfg, self.loader, self.dataset, self.predict_voxels()
        )
        if self.dp.rank != 0:
            return metrics
        if vis:
            self.write_overlays(preds_img, samples, vis_count)
        result_dir = f"{cfg.output_dir}/result"
        os.makedirs(result_dir, exist_ok=True)
        for k, v in sorted(metrics.items()):
            self.logger.info("%s: %.2f", k, v)
        with open(f"{result_dir}/metrics_{name}.json", "w") as f:
            json.dump(metrics, f, indent=1)
        np.save(f"{result_dir}/preds_{name}.npy", preds_img)
        if cfg.eval.dump_artifacts:
            self._write_upstream_artifacts(result_dir, name, preds_img, samples, preds_cam)
        return metrics

    def write_overlays(self, preds_img: np.ndarray, samples, count: int):
        """The reference's overlays (``utils.vis.vis_keypoints``) of the first
        ``count`` predictions (original-image px) on their frames, written
        as ``{output_dir}/vis/pred_{i}.jpg`` (JPEG quality 95, as
        ``cv2.imwrite`` writes JAX's). A frame on disk is decoded by
        ``jpeg.decode`` on the Tester's device, a synthetic one rendered;
        the overlay is drawn on the host and encoded by ``jpeg.encode`` on
        the Tester's device."""
        from ihpr_tpu_torch.data import jpeg
        from ihpr_tpu_torch.data.datasets import render_synthetic_image
        from ihpr_tpu_torch.utils.vis import vis_keypoints

        vis_dir = f"{self.cfg.output_dir}/vis"
        os.makedirs(vis_dir, exist_ok=True)
        n = min(count, len(samples))
        for i in range(n):
            s = samples[i]
            if s.get("img_path") is None:
                img = render_synthetic_image(s)
            else:
                with open(s["img_path"], "rb") as f:
                    img = jpeg.decode([f.read()], self.device, [s["img_path"]])[0].cpu().numpy()
            overlay = vis_keypoints(img, preds_img[i], self.dataset.skeleton)
            blob = jpeg.encode([overlay], device=self.device)[0]
            with open(f"{vis_dir}/pred_{i}.jpg", "wb") as f:
                f.write(blob)
        self.logger.info("wrote %d overlays to %s", n, vis_dir)

    def _write_upstream_artifacts(self, result_dir, name, preds_img, samples, preds_cam):
        """Result dumps in the reference's layouts, beside the metrics json:
        - MPII: ``pred.mat`` with key 'preds' (N, 16, 2), MATLAB 1-based px;
        - Human36M: ``bbox_root_pose_h36m_output.json``, per-sample image-
          and camera-space joints;
        - MSCOCO: ``person_keypoints_result.json``, COCOeval detections."""
        if name == "MPII":
            from scipy.io import savemat

            path = f"{result_dir}/pred.mat"
            savemat(path, {"preds": preds_img[:, :, :2].astype(np.float64) + 1.0})
        elif name == "Human36M":
            path = f"{result_dir}/bbox_root_pose_h36m_output.json"
            out = [
                dict(image_path=s.get("img_path"), action=s.get("action", ""),
                     joint_img=pred.tolist(), joint_cam=cam.tolist())
                for pred, cam, s in zip(preds_img, preds_cam, samples)
            ]
            with open(path, "w") as f:
                json.dump(out, f)
        elif name == "MSCOCO":
            path = f"{result_dir}/person_keypoints_result.json"
            out = []
            for i, (pred, s) in enumerate(zip(preds_img, samples)):
                kpts = np.concatenate([pred[:, :2], np.ones((pred.shape[0], 1), np.float32)], 1)
                out.append(dict(image_id=int(s.get("image_id", i)), category_id=1,
                                keypoints=[round(float(v), 2) for v in kpts.reshape(-1)], score=1.0))
            with open(path, "w") as f:
                json.dump(out, f)
        else:
            return
        self.logger.info("wrote %s", path)
