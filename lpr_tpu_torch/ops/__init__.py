"""NHWC tensor ops: convolutions, image geometry, resampling, NMS."""
