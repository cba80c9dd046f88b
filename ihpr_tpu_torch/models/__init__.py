"""ResNet backbone, deconv head and PoseNet (eval)."""
