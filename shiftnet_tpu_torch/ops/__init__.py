"""Tensor ops of the port: shifts, norm, resize, and the CUDA kernels of
the TFR U-Net (``chw``)."""
