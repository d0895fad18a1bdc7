"""Scale-out layer (port of vins_tpu/parallel): device meshes over a
torch.distributed process group, B independent VIO streams through one
vmapped backend step, the global BA over the keyframe map on one device
or with its landmarks sharded over the mesh's `block` axis (one
all_reduce of the reduced camera system per LM iteration), and its
strong-scaling report."""
from .batched import (make_batched_sequence_runner, make_batched_step,
                      stack_inputs, stack_states)
from .dist_ba import BAProblem, BAState, solve_ba, solve_ba_sharded
from .harvest import apply_ba_result, harvest_ba_problem
from .mesh import make_mesh, shard_leading
from .scaling import format_scaling_md, scaling_report

__all__ = [
    "make_mesh", "shard_leading",
    "make_batched_step", "make_batched_sequence_runner",
    "stack_states", "stack_inputs",
    "BAProblem", "BAState", "solve_ba", "solve_ba_sharded",
    "apply_ba_result", "harvest_ba_problem",
    "format_scaling_md", "scaling_report",
]
