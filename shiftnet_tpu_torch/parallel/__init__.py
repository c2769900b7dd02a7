"""Data and sequence parallelism on ``torch.distributed`` (counterpart of
``shiftnet_tpu.parallel``)."""
