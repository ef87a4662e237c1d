from .mesh import describe_state_mesh
from .spmd import build_replica_states, make_step, stack_states

__all__ = [
    "build_replica_states",
    "describe_state_mesh",
    "make_step",
    "stack_states",
]
