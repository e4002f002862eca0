"""Backward bilinear warping and motion composition (PyTorch port of
``opticalflow2d_tpu.ops.warp``).

- ``warp2d``: reference ``src/Image.cpp:119-182``
- ``compose`` (= ``Motion::accumulate``): reference ``src/Motion.cpp:113-178``

Both live with their CUDA kernel in ``kernels.warp_fused``: a CUDA tensor
goes to the gather kernel, a CPU tensor to its plain version. The JAX
package's roll path, its displacement bound and the ``lax.cond`` fallback
stood in for the gather a TPU lacks and have no counterpart here.
"""

from opticalflow2d_tpu_torch.kernels.warp_fused import compose, warp2d

__all__ = ["warp2d", "compose"]
