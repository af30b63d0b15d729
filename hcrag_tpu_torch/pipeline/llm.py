"""Host-side LLM client with the reference's failure semantics.

Counterpart of `hcrag_tpu/pipeline/llm.py`: `LLMClient.call` and
`LLMClient.call_stream` against any OpenAI-compatible chat-completions
endpoint, `FALLBACK_ANSWER`, and the structured response models
(`QueryIntentResponse`, `EntityExtractionResponse`, `Decision`,
`RelevanceScore`, `BatchRelevanceScore`).  Failure behaviour is part of the
contract:

  * no endpoint configured -> the fallback at once (offline mode);
  * a failed plain call    -> the fixed apology string;
  * a failed structured call -> the caller's fallback object (a failed
    intent call: product search at confidence 0.5);
  * a failed or offline stream -> the fallback answer, emitted through the
    token callback in word chunks.

Standard library only, on purpose: the response models are dataclasses with
the JSON schema pydantic gives the JAX package's models, and the transport
is `urllib.request` (the machines the port runs on need neither pydantic
nor httpx).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import re
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Type

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


def _integer(x: Any) -> int:
    """A JSON value as an int, as pydantic's lax int field takes it:
    integers, booleans, integral floats and integer strings."""
    if isinstance(x, (bool, int)):
        return int(x)
    if isinstance(x, float) and x.is_integer():
        return int(x)
    if isinstance(x, str):
        return int(x.strip())
    raise ValueError(f"not an integer: {x!r}")


def _string(x: Any) -> str:
    if not isinstance(x, str):
        raise ValueError(f"not a string: {x!r}")
    return x


def _optional_string(x: Any) -> Optional[str]:
    return None if x is None else _string(x)


def _list_of(item: Callable[[Any], Any]) -> Callable[[Any], list]:
    def convert(x: Any) -> list:
        if not isinstance(x, list):
            raise ValueError(f"not a list: {x!r}")
        return [item(v) for v in x]

    return convert


class _Model:
    """The slice of pydantic's model API the package uses.  A subclass is a
    dataclass with its JSON schema in `SCHEMA` and one converter per field
    in `FIELDS`; a field without a default is required."""

    SCHEMA: Dict[str, Any] = {}
    FIELDS: Dict[str, Callable[[Any], Any]] = {}

    @classmethod
    def model_json_schema(cls) -> Dict[str, Any]:
        return json.loads(json.dumps(cls.SCHEMA))

    @classmethod
    def model_validate(cls, data: Any):
        if isinstance(data, cls):
            return data
        if not isinstance(data, dict):
            raise ValueError(f"{cls.__name__} needs an object, got {data!r}")
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in data:
                kwargs[f.name] = cls.FIELDS[f.name](data[f.name])
            elif f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING:
                raise ValueError(f"{cls.__name__} needs '{f.name}'")
        return cls(**kwargs)

    @classmethod
    def model_validate_json(cls, text: str):
        return cls.model_validate(json.loads(text))

    def model_dump(self) -> Dict[str, Any]:
        return {
            f.name: (v.model_dump() if isinstance(v, _Model) else copy.deepcopy(v))
            for f in dataclasses.fields(self)
            for v in (getattr(self, f.name),)
        }


def _model(name: str, description: str, props: Dict[str, Dict]) -> Dict[str, Any]:
    """The JSON schema pydantic gives a model of required fields."""
    return {
        "description": description,
        "properties": props,
        "required": list(props),
        "title": name,
        "type": "object",
    }


def _prop(title: str, kind: str, description: Optional[str] = None, **extra) -> Dict:
    out = {"description": description} if description else {}
    out.update(title=title, type=kind, **extra)
    return out


def _nullable(title: str, description: Optional[str] = None) -> Dict:
    """pydantic's schema of an `Optional[str] = None` field."""
    out = {"anyOf": [{"type": "string"}, {"type": "null"}], "default": None}
    if description:
        out["description"] = description
    out["title"] = title
    return out


@dataclasses.dataclass
class QueryIntentResponse(_Model):
    """An intent classification with its confidence and reasoning."""

    intent: str
    confidence: float
    reasoning: str

    SCHEMA = _model("QueryIntentResponse", "neo4j_rag_langgraph.py:178-188", {
        "intent": _prop("Intent", "string", (
            "Query intent: product_search, document_request, technical_support, "
            "comparison_request, or specification_inquiry")),
        "confidence": _prop("Confidence", "number",
                            "Confidence level in detected intent (0-1)"),
        "reasoning": _prop("Reasoning", "string",
                           "Brief explanation of why this intent was chosen"),
    })
    FIELDS = {"intent": _string, "confidence": _number, "reasoning": _string}


@dataclasses.dataclass
class EntityExtractionResponse(_Model):
    """Entities extracted from a query, with the reasoning."""

    entities: List[str]
    reasoning: str

    SCHEMA = _model("EntityExtractionResponse", "neo4j_rag_langgraph.py:236-244", {
        "entities": _prop("Entities", "array",
                          "List of relevant entities extracted from the query",
                          items={"type": "string"}),
        "reasoning": _prop("Reasoning", "string",
                           "Brief explanation of why these entities were extracted"),
    })
    FIELDS = {"entities": _list_of(_string), "reasoning": _string}


@dataclasses.dataclass
class Decision(_Model):
    """The supervisor's verdict on the context: 'sufficient' or
    'revision'."""

    decision: str
    reasoning: str

    SCHEMA = _model("Decision", "neo4j_rag_langgraph.py:626-629", {
        "decision": _prop("Decision", "string", "'sufficient' or 'revision'"),
        "reasoning": _prop("Reasoning", "string", "Brief explanation of the decision"),
    })
    FIELDS = {"decision": _string, "reasoning": _string}


@dataclasses.dataclass
class RelevanceScore(_Model):
    """One relevance score."""

    score: float

    SCHEMA = _model("RelevanceScore", "isRelevant.py:118-119",
                    {"score": _prop("Score", "number")})
    FIELDS = {"score": _number}


@dataclasses.dataclass
class BatchRelevanceScore(_Model):
    """One relevance score per node of a batch."""

    scores: List[float]

    SCHEMA = _model("BatchRelevanceScore", "isRelevant.py:122-126", {
        "scores": _prop("Scores", "array",
                        "List of relevance scores for each node in the batch",
                        items={"type": "number"}),
    })
    FIELDS = {"scores": _list_of(_number)}


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

    def _request(self, payload: dict) -> urllib.request.Request:
        return urllib.request.Request(
            self.config.llm_base_url.rstrip("/") + "/chat/completions",
            data=json.dumps(payload).encode(),
            headers={
                "Authorization": f"Bearer {self.config.llm_api_key}",
                "Content-Type": "application/json",
            },
            method="POST",
        )

    def _payload(self, system_prompt: str, user_prompt: str,
                 max_tokens: Optional[int], temperature: Optional[float]) -> dict:
        payload: dict = {
            "model": self.config.llm_model,
            "messages": [
                {"role": "system", "content": system_prompt},
                {"role": "user", "content": user_prompt},
            ],
        }
        if max_tokens is not None:
            payload["max_tokens"] = max_tokens
        if temperature is not None:
            payload["temperature"] = temperature
        return payload

    def _post(self, payload: dict, response_format: Optional[Type[_Model]],
              timeout) -> str:
        if response_format is not None:
            payload["response_format"] = {
                "type": "json_schema",
                "json_schema": {
                    "name": response_format.__name__,
                    "schema": response_format.model_json_schema(),
                },
            }
        with urllib.request.urlopen(self._request(payload), timeout=timeout) as resp:
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
                self._payload(system_prompt, user_prompt, max_tokens, temperature),
                response_format,
                timeout,
            )
            if response_format is None:
                return content
            return self._parse(content, response_format)
        except Exception:  # any transport or parse failure falls back
            self.failure_count += 1
            return self._fallback(response_format, fallback)

    def call_stream(
        self,
        system_prompt: str,
        user_prompt: str,
        on_token: Callable[[str], None],
        *,
        timeout: Optional[float] = None,
        fallback: Any = None,
        max_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
    ) -> str:
        """Incremental answer generation over the streaming API (SSE
        `data:` lines carrying `delta.content` chunks): `on_token(chunk)`
        fires for every chunk before the accumulated answer is returned.
        Offline, on failure or on an empty stream, the fallback answer
        (`fallback()` if callable, else `fallback`, else FALLBACK_ANSWER) is
        emitted through `on_token` in word chunks and returned."""
        timeout = timeout if timeout is not None else self.config.llm_timeout_s
        self.call_count += 1

        def emit_fallback() -> str:
            self.failure_count += 1
            answer = fallback() if callable(fallback) else fallback
            if not isinstance(answer, str) or not answer:
                answer = FALLBACK_ANSWER
            words = answer.split(" ")
            for i, w in enumerate(words):
                on_token(w if i == len(words) - 1 else w + " ")
            return answer

        if self.offline:
            return emit_fallback()
        payload = self._payload(system_prompt, user_prompt, max_tokens, temperature)
        payload["stream"] = True
        parts: List[str] = []
        try:
            with urllib.request.urlopen(self._request(payload), timeout=timeout) as resp:
                for raw in resp:
                    line = raw.decode().strip()
                    if not line.startswith("data:"):
                        continue
                    data = line[len("data:"):].strip()
                    if data == "[DONE]":
                        break
                    try:
                        delta = json.loads(data)["choices"][0].get("delta", {})
                    except (ValueError, KeyError, IndexError, TypeError, AttributeError):
                        continue  # a malformed event is skipped
                    chunk = delta.get("content")
                    if chunk:
                        parts.append(chunk)
                        on_token(chunk)
        except Exception:  # any transport failure falls back
            return emit_fallback()
        if not parts:
            return emit_fallback()
        return "".join(parts)

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
        if response_format is QueryIntentResponse:
            return QueryIntentResponse(
                intent="product_search",
                confidence=0.5,
                reasoning="Fallback due to LLM timeout",
            )
        return "Error: LLM timeout"
