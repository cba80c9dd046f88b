"""Faults planted under the timed path, for the tests that see ``correct``
come out false and for the readings that set the limits' upper ends. Each
is a context manager that patches the program while it is open."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def unchanged_state():
    """The optimizer's step returns and leaves every parameter as it was."""
    from ihpr_tpu_torch.parallel import train_step

    return _patched(train_step.OptaxAdam, "step", lambda self, closure=None: None)


def half_batch():
    """The train step's loss is the mean over the first half of the rows."""
    from ihpr_tpu_torch.parallel import train_step

    loss = train_step.joint_location_loss

    def half(coords, joint_img, joint_vis, have_depth):
        h = coords.shape[0] // 2
        return loss(coords[:h], joint_img[:h], joint_vis[:h], have_depth[:h])

    return _patched(train_step, "joint_location_loss", half)


def altered_answer(voxels: float = 8.0):
    """Each dispatch's first person's first joint moved by ``voxels`` (an
    eighth of the box) in x where the server produces its coords."""
    from ihpr_tpu_torch.engine.server import PoseServer

    forward = PoseServer._forward

    def altered(self, patch_u8, color_scale):
        coords = forward(self, patch_u8, color_scale).clone()
        coords[0, 0, 0] += voxels
        return coords

    return _patched(PoseServer, "_forward", altered)


def half_dispatch():
    """The server computes the first half of each dispatch's people and hands
    the last of them to the rest."""
    import numpy as np
    from ihpr_tpu_torch.engine.server import PoseServer

    submit = PoseServer.submit_patches

    def half(self, patches_u8):
        b = len(patches_u8)
        h = max(1, b // 2)
        kept = np.concatenate([patches_u8[:h], np.repeat(patches_u8[h - 1:h], b - h, 0)])
        return submit(self, kept)

    return _patched(PoseServer, "submit_patches", half)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch, "altered_answer": altered_answer,
          "half_dispatch": half_dispatch}
