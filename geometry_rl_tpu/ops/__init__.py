"""Compute kernels — the hot-op namespace.

Implementations live next to their consumers; this package is the public
surface for the framework's performance-critical primitives:

- `gather_nodes` / `scatter_sum` / `scatter_mean`: graph message-passing
  gathers and scatters, lowered to one-hot matmuls for small node counts
  (see models/common.py).
- `kl_diag_cov_projection`: the on-device differentiable trust-region
  covariance projection (custom_vjp bisection dual solve) replacing ITPAL.
- `cloth_position_solve`: fused cloth XPBD position solve, one GPU kernel
  launch per substep (Pallas, Triton route; sim/pallas_cloth.py).
- `polygon_sdf_2d` / `hole_plate_sdf`: analytic contact SDFs.
"""

from ..models.common import gather_nodes, scatter_mean, scatter_sum  # noqa: F401
from ..rl.projections.kl import kl_diag_cov_projection  # noqa: F401
from ..sim.pallas_cloth import cloth_position_solve  # noqa: F401
from ..sim.shapes import hole_plate_sdf, polygon_sdf_2d  # noqa: F401
from ..sim.types import ClothSolveSpec  # noqa: F401
