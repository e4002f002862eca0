"""Device meshes (PyTorch port of ``opticalflow2d_tpu.parallel.mesh``).

A mesh is a ``(data, x)`` grid of ``torch.device``s:
- ``"data"``: a batch of pairs split into one contiguous slice a row, each
  registered on the row's first device (``parallel.batch.register_batch``),
  the replacement for the reference wrapper's one-pair-at-a-time loop
  (``WrapperOpticalFlow2d.cpp:86-102``);
- ``"x"``: strips of the image's x axis, with halo exchange between them
  (``parallel.spatial``; its drivers take a mesh of one data row).

One process drives every device of the mesh, as the JAX package's single
controller does. A device may appear more than once: strips on one card run
side by side there, as the JAX package's tests run eight strips on virtual
CPU devices.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch


class Mesh(NamedTuple):
    """``devices[d][s]`` is the device of strip ``s`` of data row ``d``."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "x": len(self.devices[0])}

    def x_devices(self) -> List[torch.device]:
        """The strips' devices, in strip order (data row 0)."""
        return list(self.devices[0])

    def data_devices(self) -> List[torch.device]:
        """The first device of each data row, in row order: where
        ``register_batch`` runs the row's pairs."""
        return [row[0] for row in self.devices]


def make_mesh(data: int = 1, x: int = 1,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """Build a ``(data, x)`` mesh over the given devices, or over the first
    ``data * x`` CUDA devices."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = data * x
    if n < 1:
        raise ValueError(f"a mesh needs data, x >= 1, got data={data}, x={x}")
    if len(devices) < n:
        raise ValueError(f"need {n} devices for mesh (data={data}, x={x}), have "
                         f"{len(devices)}; pass devices= (a device may repeat)")
    return Mesh(tuple(tuple(devices[r * x:(r + 1) * x]) for r in range(data)))
