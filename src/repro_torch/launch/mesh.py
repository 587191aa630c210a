"""Production mesh shapes (the port's counterpart of the reference's
``launch/mesh.py``): the axis sizes the dry run places parameters, caches
and inputs over. No devices are made or counted here; the meshes that
hold process groups (serving, elastic) come with the sharded serving path
(ROADMAP item 11)."""
from __future__ import annotations

from typing import Dict


def _validate_axes(**sizes) -> None:
    for name, n in sizes.items():
        if not isinstance(n, int) or isinstance(n, bool) or n < 1:
            raise ValueError(f"mesh axis {name!r} must be a positive int, "
                             f"got {n!r}")


def production_mesh_shape(multi_pod: bool = False) -> Dict[str, int]:
    """Axis sizes of the production mesh: 16 x 16 ``data`` x ``model``, or
    2 x 16 x 16 with a leading ``pod`` axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    sizes = dict(zip(axes, shape))
    _validate_axes(**sizes)
    return sizes
