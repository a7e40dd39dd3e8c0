from triad.parallel.distributed import (
    fetch,
    global_batch_from_local,
    initialize_from_env,
    process_shard,
    put_global_tree,
)
from triad.parallel.dp import (
    distributed_av_loss,
    distributed_tv_loss,
    make_mesh,
)
from triad.parallel.fsdp import fsdp_param_specs
from triad.parallel.tp import (
    make_dp_tp_mesh,
    resolve_xla_impls,
    tp_param_specs,
    tp_state_shardings,
)
from triad.parallel.zero import (
    apply_zero1,
    zero1_state_shardings,
)

__all__ = [
    "distributed_av_loss",
    "distributed_tv_loss",
    "make_mesh",
    "apply_zero1",
    "zero1_state_shardings",
    "fetch",
    "global_batch_from_local",
    "initialize_from_env",
    "process_shard",
    "put_global_tree",
    "fsdp_param_specs",
    "make_dp_tp_mesh",
    "resolve_xla_impls",
    "tp_param_specs",
    "tp_state_shardings",
]
