"""tfmpc-tpu on PyTorch and CUDA: batched iLQR for model-predictive control.

The port of the JAX package ``tfmpc_tpu`` to PyTorch, with the Pallas
kernels of its main path rewritten as hand-written CUDA kernels for Hopper
(``ops/csrc``). The layout mirrors the JAX package (``core``, ``models``,
``solvers``, ``ops``, ``parallel``, ``utils``) and so does the top-level
API: the same 31 names. Kernels are built with ``nvcc`` at their first
launch, never at import, so ``import tfmpc_tpu_torch`` needs neither a GPU
nor a CUDA toolkit; it imports neither pandas nor the command line's
modules either.
"""

from tfmpc_tpu_torch.core.types import (
    Bounds,
    LinearModel,
    LQRProblem,
    Policy,
    QuadraticFinal,
    QuadraticModel,
    SecondOrderModel,
    ValueFunction,
)
from tfmpc_tpu_torch.models.base import Env
from tfmpc_tpu_torch.models.hvac import HVAC, make_hvac
from tfmpc_tpu_torch.models.linear import LinearSystem, make_linear_system
from tfmpc_tpu_torch.models.navigation import Navigation, make_navigation
from tfmpc_tpu_torch.models.problems import make_lqr, make_lqr_linear_navigation
from tfmpc_tpu_torch.models.registry import load_env, make_env
from tfmpc_tpu_torch.models.reservoir import Reservoir, make_reservoir
from tfmpc_tpu_torch.solvers import ilqr, lqr, mpc
from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig, ILQRResult, ILQRTrace
from tfmpc_tpu_torch.solvers.ilqr_batched import SolverState, state_from_result
from tfmpc_tpu_torch.utils import checkpoint
from tfmpc_tpu_torch.utils.trajectory import Trajectory

__version__ = "0.1.0"

__all__ = [
    "Bounds",
    "Env",
    "HVAC",
    "ILQRConfig",
    "ILQRResult",
    "ILQRTrace",
    "SolverState",
    "LQRProblem",
    "LinearModel",
    "LinearSystem",
    "Navigation",
    "Policy",
    "QuadraticFinal",
    "QuadraticModel",
    "Reservoir",
    "SecondOrderModel",
    "Trajectory",
    "ValueFunction",
    "checkpoint",
    "ilqr",
    "load_env",
    "lqr",
    "make_env",
    "mpc",
    "state_from_result",
    "make_hvac",
    "make_linear_system",
    "make_lqr",
    "make_lqr_linear_navigation",
    "make_navigation",
    "make_reservoir",
]
