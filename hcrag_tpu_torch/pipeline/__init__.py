"""The host pipeline over the engine: so far the `isRelevant` scorer and
the LLM client it calls."""

from hcrag_tpu_torch.pipeline.isrelevant import (  # noqa: F401
    batch_isRelevant,
    isRelevant,
)
from hcrag_tpu_torch.pipeline.llm import LLMClient  # noqa: F401
