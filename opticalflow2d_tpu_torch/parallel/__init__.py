"""Scaling layer of the port: device meshes and the strip-parallel
registration drivers (diffusion, elastic and fluid), one process over a
mesh whose x axis is a list of devices."""

from opticalflow2d_tpu_torch.parallel.mesh import Mesh, make_mesh
from opticalflow2d_tpu_torch.parallel.spatial import (
    SPResult,
    make_diffusion_sweeps_sharded,
    make_fluid_level_sharded,
    make_register_sp,
    make_sor_sweeps_sharded,
    make_variational_level_sharded,
    make_warp2d_sharded,
)

__all__ = [
    "Mesh", "make_mesh", "SPResult",
    "make_diffusion_sweeps_sharded", "make_sor_sweeps_sharded", "make_warp2d_sharded",
    "make_variational_level_sharded", "make_fluid_level_sharded", "make_register_sp",
]
