"""cellularautomatons3d_tpu — a JAX 3D cellular-automaton engine.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
``lightest/cellularautomatons3d`` (a WebGPU browser app): totalistic 3D CA
with born/survive neighbour-count rules over configurable neighbourhoods,
bit-packed 32-cells-per-uint32 state, multi-state (Generations) decay, and a
physically based per-pixel ray-marched volume renderer with stochastic
shadow rays and temporal reprojection — running as jitted on-device programs
with zero per-frame host round-trips, and scaling past one chip via
``jax.sharding`` halo exchange.

See SURVEY.md for the structural analysis of the reference and the layer
mapping; citations into /root/reference appear throughout the docstrings.
"""

from .utils.config import EngineConfig, LightConfig, BoundaryMode
from .models import (
    AutomatonSpec,
    RuleSet,
    NEIGHBOURHOOD_MAP,
    get_neighbourhood,
    PRESETS,
    preset_config,
)
from .engine import Engine
from .utils import image, metrics, profiling, video
from .ops import (
    pack_grid,
    unpack_grid,
    seed_center,
    seed_random_block,
    step_dense,
    step_packed,
    step_packed_multistate,
    make_step_fn,
)

__version__ = "0.1.0"

__all__ = [
    "Engine",
    "EngineConfig",
    "LightConfig",
    "BoundaryMode",
    "AutomatonSpec",
    "RuleSet",
    "NEIGHBOURHOOD_MAP",
    "get_neighbourhood",
    "PRESETS",
    "preset_config",
    "pack_grid",
    "unpack_grid",
    "seed_center",
    "seed_random_block",
    "step_dense",
    "step_packed",
    "step_packed_multistate",
    "make_step_fn",
    "image",
    "metrics",
    "profiling",
    "video",
    "__version__",
]
