"""Domain / grid geometry for STKDE.

Conventions:
  * The domain is a box ``[ox, ox+gx) x [oy, oy+gy) x [ot, ot+gt)`` in
    *domain space* (meters / days).
  * Voxel ``(X, Y, T)`` samples the domain at its **center**
    ``origin + (idx + 0.5) * res``.
  * Uppercase = voxel space, lowercase = domain space (paper Table 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Domain:
    """Discretized space-time domain.

    Attributes mirror the paper's notation: ``g*`` domain extent, ``sres`` /
    ``tres`` resolutions, ``G*`` grid extents in voxels, ``hs`` / ``ht``
    bandwidths (domain space), ``Hs`` / ``Ht`` bandwidths in voxels.
    """

    gx: float
    gy: float
    gt: float
    sres: float
    tres: float
    hs: float
    ht: float
    ox: float = 0.0
    oy: float = 0.0
    ot: float = 0.0

    # ------------------------------------------------------------------ grid
    @property
    def Gx(self) -> int:
        return max(1, math.ceil(self.gx / self.sres))

    @property
    def Gy(self) -> int:
        return max(1, math.ceil(self.gy / self.sres))

    @property
    def Gt(self) -> int:
        return max(1, math.ceil(self.gt / self.tres))

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return (self.Gx, self.Gy, self.Gt)

    @property
    def Hs(self) -> int:
        return max(1, math.ceil(self.hs / self.sres))

    @property
    def Ht(self) -> int:
        return max(1, math.ceil(self.ht / self.tres))

    @property
    def grid_voxels(self) -> int:
        return self.Gx * self.Gy * self.Gt

    @property
    def grid_mbytes(self) -> float:
        return self.grid_voxels * 4 / 2**20

    @property
    def cylinder_voxels(self) -> int:
        """Voxels in one point's bounding box (2Hs+1)^2 x (2Ht+1)."""
        return (2 * self.Hs + 1) ** 2 * (2 * self.Ht + 1)

    # ------------------------------------------------------- transformations
    def _centers(self, n: int, origin: float, res: float,
                 device: DeviceLike) -> torch.Tensor:
        idx = torch.arange(n, dtype=torch.float32,
                           device=resolve_device(device))
        return origin + (idx + 0.5) * res

    def voxel_centers_x(self, device: DeviceLike = None) -> torch.Tensor:
        return self._centers(self.Gx, self.ox, self.sres, device)

    def voxel_centers_y(self, device: DeviceLike = None) -> torch.Tensor:
        return self._centers(self.Gy, self.oy, self.sres, device)

    def voxel_centers_t(self, device: DeviceLike = None) -> torch.Tensor:
        return self._centers(self.Gt, self.ot, self.tres, device)

    def point_voxels(self, pts: torch.Tensor) -> torch.Tensor:
        """Map points ``(n, 3)`` [x, y, t] -> integer voxel indices ``(n, 3)``
        on the points' device.

        Clipped into the grid so every point has a well-defined home voxel.
        """
        hi = torch.tensor(
            [self.Gx - 1, self.Gy - 1, self.Gt - 1], dtype=torch.int32,
            device=pts.device,
        )
        vox = self.point_voxels_unclipped(pts)
        return torch.minimum(torch.clamp(vox, min=0), hi)

    def point_voxels_unclipped(self, pts: torch.Tensor) -> torch.Tensor:
        """Voxel indices that may lie outside the grid (for subdomain views:
        a point outside a local domain still radiates density into it).

        The divisor is a tensor on the points' device, so the quotient is a
        true division there as well (a Python scalar divisor is turned into a
        multiplication by its reciprocal on CUDA).
        """
        scale = torch.tensor([self.sres, self.sres, self.tres],
                             dtype=pts.dtype, device=pts.device)
        orig = torch.tensor([self.ox, self.oy, self.ot],
                            dtype=pts.dtype, device=pts.device)
        return torch.floor((pts - orig) / scale).to(torch.int32)

    def with_bandwidth(self, hs: float, ht: float) -> "Domain":
        return dataclasses.replace(self, hs=hs, ht=ht)

    def with_resolution(self, sres: float, tres: float) -> "Domain":
        return dataclasses.replace(self, sres=sres, tres=tres)

    # ------------------------------------------------------------- reporting
    def describe(self) -> str:
        return (
            f"grid {self.Gx}x{self.Gy}x{self.Gt} ({self.grid_mbytes:.0f} MB)"
            f" Hs={self.Hs} Ht={self.Ht} cyl={self.cylinder_voxels} vox"
        )


def from_points(
    pts: np.ndarray, sres: float, tres: float, hs: float, ht: float
) -> Domain:
    """Build a Domain whose box is the bounding box of ``pts`` (+1 voxel pad)."""
    pts = np.asarray(pts)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    span = np.maximum(hi - lo, [sres, sres, tres])
    return Domain(
        gx=float(span[0] + sres),
        gy=float(span[1] + sres),
        gt=float(span[2] + tres),
        sres=sres,
        tres=tres,
        hs=hs,
        ht=ht,
        ox=float(lo[0]),
        oy=float(lo[1]),
        ot=float(lo[2]),
    )
