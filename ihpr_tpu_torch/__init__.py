"""ihpr_tpu_torch — the PyTorch/CUDA port of ihpr_tpu, for NVIDIA Hopper.

Same layout and names as ``ihpr_tpu`` (the JAX reference, which this
package never imports):

    config    — frozen dataclass configs and the named CONFIGS
    data      — skeletons, bbox geometry, patch affines, native warp binding,
                the finalize_patch device tail
    ops       — plain integral soft-argmax; the fused final-conv + integral
                op with its hand-written CUDA kernel (ops/csrc)
    models    — ResNet backbone, deconv head, PoseNet, weight conversion
    engine    — PoseServer (batched serving with flip-test)
"""

__version__ = "0.1.0"
