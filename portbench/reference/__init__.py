"""Plain reference of the benchmark's cells.

Plain PyTorch, written from the published physics (Cheetah's first-order
maps, its Gaussian moment transport and its integrated-Green-function
space-charge kick) and independent of the program under test: nothing
here imports the port or the JAX package. It takes only the inputs the
benchmark hands both sides (the lattice as data, the beam's particles or
moments, the per-step settings) and works out the maps, the Green
function and the grids again. It runs in float64 as the yardstick, and in
float32 with TF32 matrix products as the control.
"""

from portbench.reference.lattice import (
    ParticleState,
    env_reward,
    env_reward_and_grad,
    track_grad,
)

__all__ = ["ParticleState", "env_reward", "env_reward_and_grad", "track_grad"]
