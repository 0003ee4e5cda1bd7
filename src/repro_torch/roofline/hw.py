"""NVIDIA H100 SXM figures for the roofline: the port's counterpart of
``repro.roofline.hw``.

From NVIDIA's H100 Tensor Core GPU data sheet (SXM5 part, dense rates
without sparsity, at the 700 W power limit):

  * ``PEAK_FLOPS_BF16``: 989 TFLOP/s of bf16 on the tensor cores.
  * ``HBM_BW``: 3.35 TB/s of HBM3.
  * ``LINK_BW``: the collective term's single-link basis, as the JAX
    package takes one ICI link. The production meshes are 16 wide on
    every axis and an NVLink domain holds 8 cards (one HGX host), so every
    axis's collectives leave the host: they run at the per-GPU network
    link, one 400 Gb/s NDR InfiniBand port (ConnectX-7) a GPU = 50e9
    bytes/s. NVLink's 450 GB/s a direction applies only inside a host.

``HBM_BYTES`` is what the card reports, not the data sheet's 80 GB:
``torch.cuda.get_device_properties(0).total_memory`` on an NVIDIA H100
80GB HBM3 at a 700.00 W power limit (``nvidia-smi --query-gpu=name,
power.limit``); ``scripts/torch_time_kernels.py`` prints both.
"""

PEAK_FLOPS_BF16 = 989e12      # per GPU, bf16 dense, tensor cores
HBM_BW = 3.35e12              # bytes/s per GPU, HBM3
LINK_BW = 50e9                # bytes/s per GPU, one NDR InfiniBand port

HBM_BYTES = 85_017_493_504    # total_memory of an H100 80GB HBM3
