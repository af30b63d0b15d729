"""Host-side LLM client with the reference's failure semantics.

Counterpart of the part of `hcrag_tpu/pipeline/llm.py` that `isRelevant`
needs: `LLMClient.call` against any OpenAI-compatible chat-completions
endpoint, `FALLBACK_ANSWER`, and the `RelevanceScore` /
`BatchRelevanceScore` response models.  Failure behaviour is part of the
contract:

  * no endpoint configured -> the fallback at once (offline mode);
  * a failed plain call    -> the fixed apology string;
  * a failed structured call -> the caller's fallback object.

Standard library only, on purpose: the response models are dataclasses with
the JSON schema pydantic gives the JAX package's models, and the transport
is `urllib.request` (the machines the port runs on need neither pydantic
nor httpx).
"""

from __future__ import annotations

import dataclasses
import json
import re
import urllib.request
from typing import Any, Dict, List, Optional, Type

from hcrag_tpu_torch.config import GLOBAL_CONFIG, RuntimeConfig

FALLBACK_ANSWER = (
    "I apologize, but I'm having trouble processing your request due to a "
    "technical issue. Please try again."
)


def _number(x: Any) -> float:
    """A JSON value as a float, as pydantic's lax float field takes it:
    numbers, booleans and numeric strings."""
    if isinstance(x, (bool, int, float)):
        return float(x)
    if isinstance(x, str):
        return float(x.strip())
    raise ValueError(f"not a number: {x!r}")


class _Model:
    """The slice of pydantic's model API the client uses."""

    SCHEMA: Dict[str, Any] = {}

    @classmethod
    def model_json_schema(cls) -> Dict[str, Any]:
        return json.loads(json.dumps(cls.SCHEMA))

    @classmethod
    def model_validate(cls, data: Any):
        raise NotImplementedError

    @classmethod
    def model_validate_json(cls, text: str):
        return cls.model_validate(json.loads(text))


@dataclasses.dataclass
class RelevanceScore(_Model):
    """One relevance score."""

    score: float

    SCHEMA = {
        "description": "isRelevant.py:118-119",
        "properties": {"score": {"title": "Score", "type": "number"}},
        "required": ["score"],
        "title": "RelevanceScore",
        "type": "object",
    }

    @classmethod
    def model_validate(cls, data: Any) -> "RelevanceScore":
        if not isinstance(data, dict) or "score" not in data:
            raise ValueError("RelevanceScore needs an object with 'score'")
        return cls(score=_number(data["score"]))


@dataclasses.dataclass
class BatchRelevanceScore(_Model):
    """One relevance score per node of a batch."""

    scores: List[float]

    SCHEMA = {
        "description": "isRelevant.py:122-126",
        "properties": {
            "scores": {
                "description": "List of relevance scores for each node in the batch",
                "items": {"type": "number"},
                "title": "Scores",
                "type": "array",
            }
        },
        "required": ["scores"],
        "title": "BatchRelevanceScore",
        "type": "object",
    }

    @classmethod
    def model_validate(cls, data: Any) -> "BatchRelevanceScore":
        if not isinstance(data, dict) or not isinstance(data.get("scores"), list):
            raise ValueError("BatchRelevanceScore needs an object with a 'scores' list")
        return cls(scores=[_number(x) for x in data["scores"]])


_JSON_RE = re.compile(r"\{.*\}", re.DOTALL)


class LLMClient:
    """OpenAI-compatible chat-completions client with offline fallbacks.
    `call_count` counts calls, `failure_count` those that fell back."""

    def __init__(self, config: Optional[RuntimeConfig] = None):
        self.config = config or GLOBAL_CONFIG
        self.call_count = 0
        self.failure_count = 0

    @property
    def offline(self) -> bool:
        return not self.config.llm_base_url

    def _post(self, messages, response_format: Optional[Type[_Model]], timeout,
              max_tokens: Optional[int] = None,
              temperature: Optional[float] = None) -> str:
        payload: dict = {"model": self.config.llm_model, "messages": messages}
        if max_tokens is not None:
            payload["max_tokens"] = max_tokens
        if temperature is not None:
            payload["temperature"] = temperature
        if response_format is not None:
            payload["response_format"] = {
                "type": "json_schema",
                "json_schema": {
                    "name": response_format.__name__,
                    "schema": response_format.model_json_schema(),
                },
            }
        req = urllib.request.Request(
            self.config.llm_base_url.rstrip("/") + "/chat/completions",
            data=json.dumps(payload).encode(),
            headers={
                "Authorization": f"Bearer {self.config.llm_api_key}",
                "Content-Type": "application/json",
            },
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = json.loads(resp.read().decode())
        return body["choices"][0]["message"]["content"]

    def call(
        self,
        system_prompt: str,
        user_prompt: str,
        response_format: Optional[Type[_Model]] = None,
        timeout: Optional[float] = None,
        fallback: Any = None,
        max_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
    ) -> Any:
        """Text, or a parsed `response_format` instance, or the fallback on
        any failure (a failed plain call without a fallback gives
        FALLBACK_ANSWER)."""
        timeout = timeout if timeout is not None else self.config.llm_timeout_s
        self.call_count += 1
        if self.offline:
            self.failure_count += 1
            return self._fallback(response_format, fallback)
        try:
            content = self._post(
                [
                    {"role": "system", "content": system_prompt},
                    {"role": "user", "content": user_prompt},
                ],
                response_format,
                timeout,
                max_tokens=max_tokens,
                temperature=temperature,
            )
            if response_format is None:
                return content
            return self._parse(content, response_format)
        except Exception:  # any transport or parse failure falls back
            self.failure_count += 1
            return self._fallback(response_format, fallback)

    @staticmethod
    def _parse(content: str, response_format: Type[_Model]) -> _Model:
        """The response as `response_format`, or the first JSON object in
        its text (for endpoints without structured output)."""
        try:
            return response_format.model_validate_json(content)
        except ValueError:
            m = _JSON_RE.search(content)
            if m:
                return response_format.model_validate(json.loads(m.group(0)))
            raise

    @staticmethod
    def _fallback(response_format, fallback):
        if fallback is not None:
            return fallback() if callable(fallback) else fallback
        if response_format is None:
            return FALLBACK_ANSWER
        return "Error: LLM timeout"
