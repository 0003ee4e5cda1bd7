"""Checkpoint I/O and the versioned model store, on the JAX package's
on-disk layout (``repro_torch.ckpt.checkpoint``)."""
