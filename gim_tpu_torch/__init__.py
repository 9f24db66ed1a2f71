"""gim_tpu_torch: the PyTorch + CUDA port of gim_tpu for NVIDIA Hopper.

Stands beside the JAX package `gim_tpu`, which stays the reference: each
module here names the `gim_tpu` module it ports and is tested against it
on the same inputs and weights. Kernels are written by hand for sm_90a
(`csrc/`), built at first use. Entry points run on the GPU unless the
caller passes `device="cpu"`.

    from gim_tpu_torch.api import Matcher
    m = Matcher("gim_loftr")                # seeded random weights, CUDA
    result = m.match(image0, image1)        # (B, 3, H, W) in [0, 1]
"""
