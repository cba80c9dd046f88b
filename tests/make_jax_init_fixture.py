"""Writes tests/data/jax_init_flagship.npz: the first 4096 values of four
parameters of the JAX package's initial ``h36m3d_r50`` model, as JAX's
``Trainer`` draws it at seed 0 (``init_pose_net`` from
``jax.random.split(jax.random.key(0))[1]``, eager, on the CPU): the stem
conv, layer4_2's 3x3 conv, deconv1 and the final conv, each flattened in
flax's (kh, kw, in, out) layout, keyed by its path in flax's params tree
("backbone/conv1/kernel", ...).

``tests/test_torch_jax_init.py`` holds the file against JAX, and
``chip_smoke.py --only jax-init`` holds the port's draw on a host without
JAX against it. Needs JAX and flax:

    JAX_PLATFORMS=cpu python tests/make_jax_init_fixture.py
"""

import os

import numpy as np

N = 4096
LEAVES = ("backbone/conv1/kernel", "backbone/layer4_2/conv2/kernel", "head/deconv1/kernel", "head/final/kernel")
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jax_init_flagship.npz")


def leaf(params, path: str) -> np.ndarray:
    """The first N values of the parameter at ``path`` of a params tree."""
    for name in path.split("/"):
        params = params[name]
    return np.asarray(params, np.float32).reshape(-1)[:N]


def jax_trainer_params(config="h36m3d_r50", seed=0):
    """The params JAX's Trainer initializes ``config``'s model with."""
    import jax

    from ihpr_tpu.config import get_config
    from ihpr_tpu.models.pose_net import build_pose_net, init_pose_net

    cfg = get_config(config)
    init_key = jax.random.split(jax.random.key(seed))[1]
    params, _ = init_pose_net(build_pose_net(cfg), init_key, cfg.data.input_shape)
    return params


def main():
    params = jax_trainer_params()
    np.savez_compressed(PATH, **{path: leaf(params, path) for path in LEAVES})
    print(f"wrote {PATH}")


if __name__ == "__main__":
    main()
