"""Rig parallelism on the card: fleets of independent rigs, the shared
world grid, the city grid and multi-fleet serving, over logical shards
(counterpart of grid_vision_tpu/parallel/)."""

from .mesh import RigMesh, rig_mesh  # noqa: F401
from .fleet import Fleet  # noqa: F401
from .multi_fleet import MultiFleet  # noqa: F401
from .shared_grid import SharedGrid  # noqa: F401
from .city_grid import CityFusion, CityGrid  # noqa: F401
