from hcrag_tpu_torch.query.engine import QueryBatchResult, QueryEngine  # noqa: F401
from hcrag_tpu_torch.query.executor import BatchedExecutor  # noqa: F401
from hcrag_tpu_torch.query.graph_query import (  # noqa: F401
    GraphQuery,
    answer_graph_question,
    execute_graph_query,
    generate_graph_query,
)
