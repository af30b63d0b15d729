"""The host pipeline over the engine: the `isRelevant` scorer, the LLM
client, the query parser, the retrieval agents, `EnhancedRAG` and
`GraphRelevanceScorer`."""

from hcrag_tpu_torch.pipeline.agent import AgentResult, RetrievalAgent  # noqa: F401
from hcrag_tpu_torch.pipeline.enhanced import EnhancedRAG, RAGResponse  # noqa: F401
from hcrag_tpu_torch.pipeline.improved_agent import (  # noqa: F401
    ImprovedRetrievalAgent,
    InMemoryStore,
    MemorySaver,
)
from hcrag_tpu_torch.pipeline.integration import GraphRelevanceScorer  # noqa: F401
from hcrag_tpu_torch.pipeline.isrelevant import (  # noqa: F401
    batch_isRelevant,
    isRelevant,
)
from hcrag_tpu_torch.pipeline.llm import LLMClient  # noqa: F401
from hcrag_tpu_torch.pipeline.parser import QueryParser  # noqa: F401
