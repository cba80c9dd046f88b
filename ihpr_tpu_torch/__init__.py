"""ihpr_tpu_torch — the PyTorch/CUDA port of ihpr_tpu, for NVIDIA Hopper.

Same layout and names as ``ihpr_tpu`` (the JAX reference, which this
package never imports):

    config    — frozen dataclass configs and the named CONFIGS
    data      — skeletons, bbox geometry, patch affines, native warp binding,
                the device warp and make_patch_batch, the finalize_patch
                device tail, the H36M / MPII / COCO loaders and the
                synthetic set, JPEG decode and encode (nvJPEG on the card),
                the BatchLoader (host-warped patches or canvases) and its
                prefetch to the device
    ops       — plain integral soft-argmax; the fused final-conv + integral
                op (autograd Function) with its hand-written CUDA kernels,
                K1 forward and K2 backward (ops/csrc); the L1 loss
    models    — ResNet backbone, deconv head, PoseNet (fp32 parameters,
                train-mode BN), weight conversion, pretrained backbones
    parallel  — the train step (DDP on a process group), optimizer (ZeRO-1
                too) and schedule, the TrainState's state_dict; the data
                axis over torch.distributed (mesh) and local ranks (launch)
    engine    — PoseServer (batched serving with flip-test, data-parallel
                over ranks) and load_server,
                Trainer (snapshots, resume, the RSS watchdog, a profile
                window), Tester, CheckpointManager, colorlogger
    utils     — the output tree, graceful SIGTERM, host-memory helpers, a
                msgpack decoder
    train     — the training CLI (python -m ihpr_tpu_torch.train)
    test      — the evaluation CLI (python -m ihpr_tpu_torch.test)
"""

__version__ = "0.1.0"
