"""Export a training snapshot as a self-contained serving artifact
(``ihpr_tpu_torch.engine.export``), counterpart of the repository's
``tools/export_artifact.py``.

    python -m ihpr_tpu_torch.tools.export_artifact --config h36m3d_r50 \\
        --snapshot_dir /path/to/run [--epoch N] [--batch 16 | --batch poly] \\
        [--flip_test] [--device cuda] --out pose_r50.pt2

The artifact bakes the weights in and runs on ``--device``; a serving
process on a host with the same torch loads it with torch alone:

    prog = torch.export.load("pose_r50.pt2").module()
    coords = prog(patches_u8, torch.ones(B, 3))  # on the artifact's device

or with ``ihpr_tpu_torch.engine.export.load_exported``, which also applies
the config's matmul precision. Beside it goes ``{out}.json``: joint names,
flip pairs and shapes, and how voxel coords map back to pixels and mm.
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True)
    ap.add_argument("--snapshot_dir", required=True)
    ap.add_argument("--epoch", type=int, default=None, help="snapshot epoch (default: latest)")
    ap.add_argument("--batch", default="16",
                    help="fixed batch size, or 'poly' for a batch-polymorphic artifact")
    ap.add_argument("--flip_test", action="store_true")
    ap.add_argument("--device", default="cuda", help="the device the artifact runs on")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.batch != "poly":
        args.batch = int(args.batch)
    return args


def main(argv=None) -> dict:
    """Writes the artifact and its sidecar; returns the sidecar's dict."""
    args = parse_args(argv)

    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.engine.export import export_server
    from ihpr_tpu_torch.engine.server import load_server

    cfg = get_config(args.config)
    server = load_server(
        cfg, snapshot_dir=args.snapshot_dir, epoch=args.epoch,
        max_batch=16 if args.batch == "poly" else args.batch,
        flip_test=args.flip_test, device=args.device,
    )
    blob = export_server(server, batch=args.batch)
    with open(args.out, "wb") as f:
        f.write(blob)

    # Everything a consumer needs to read the (B, J, 3) voxel coords without
    # this package: joint identity and the volume -> pixel / mm constants
    # (the math is data/geometry.warp_coord_to_original, restated here).
    skel = server.skeleton
    in_h, in_w = cfg.data.input_shape
    meta = {
        "config": cfg.name,
        "inputs": [
            f"uint8 patches ({args.batch}, {in_h}, {in_w}, 3), RGB",
            f"float32 color_scale ({args.batch}, 3) — ones for eval",
        ],
        "output": "float32 voxel coords (batch, joint_num, 3) as (x, y, z)",
        "joint_names": list(skel.joints_name),
        "flip_pairs": [list(p) for p in skel.flip_pairs],
        "input_shape": list(cfg.data.input_shape),
        "output_shape": list(cfg.data.output_shape),
        "depth_dim": cfg.data.depth_dim,
        "bbox_3d_shape_mm": list(cfg.data.bbox_3d_shape),
        "flip_test_fused": bool(server.flip_test),
        "device": str(server.device),
        "matmul_precision": cfg.model.matmul_precision,
        "to_pixels": "px = voxel_xy * input_shape/output_shape, then apply "
        "the inverse bbox affine; mm_z = (voxel_z/depth_dim - 0.5) * "
        "bbox_3d_shape_mm[0] + root_z",
    }
    with open(args.out + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    print(
        f"wrote {args.out}: {len(blob) / 1e6:.1f} MB, batch {args.batch}, device "
        f"{server.device}, flip_test {server.flip_test} (+ {args.out}.json metadata)"
    )
    return meta


if __name__ == "__main__":
    main()
