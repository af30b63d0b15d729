"""The sharded engine on `torch.distributed`: meshes of ranks, the
selection and merge across ranks, the engine, and its checkpoints."""

from hcrag_tpu_torch.parallel.mesh import (  # noqa: F401
    BATCH_AXIS,
    ROWS_AXIS,
    make_batch_row_mesh,
    make_row_mesh,
)
from hcrag_tpu_torch.parallel.sharded_engine import ShardedQueryEngine  # noqa: F401
from hcrag_tpu_torch.parallel.sharded_ops import (  # noqa: F401
    sharded_row_gather,
    sharded_top_k,
)
