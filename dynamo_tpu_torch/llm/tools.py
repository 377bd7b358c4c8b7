"""Tool-calling support (port of dynamo_tpu/llm/tools.py): template-side
tool advertising and response-side call extraction.

A generated message that parses as ``{"name": ...,
"parameters"|"arguments": {...}}`` — or a JSON array of those — becomes OpenAI ``tool_calls`` entries with fresh ``call-<uuid>``
ids; ``tool_choice="none"`` disables matching entirely. On the request
side the chat template receives the ``tools`` list (HF chat templates
render it natively), which is how the model learns the available tools.
"""

from __future__ import annotations

import json
import uuid
from typing import Any


def _called(obj: Any, index: int) -> dict | None:
    """One parsed candidate → OpenAI tool_call dict, or None. `index` is
    required by strict streaming clients (ChoiceDeltaToolCall.index)."""
    if not isinstance(obj, dict) or not isinstance(obj.get("name"), str):
        return None
    args = obj.get("parameters", obj.get("arguments"))
    if not isinstance(args, dict):
        return None
    return {
        "index": index,
        "id": f"call-{uuid.uuid4()}",
        "type": "function",
        "function": {"name": obj["name"], "arguments": json.dumps(args)},
    }


class ToolCallMatcher:
    """Extracts tool calls from a completed generation.

    ``tool_choice`` semantics (OpenAI): "none" disables matching; "auto"
    matches opportunistically; "required" demands at least one call (the
    caller surfaces an error when none parses — ``required`` property);
    ``{"type": "function", "function": {"name": N}}`` forces a specific
    function — matches are filtered to N."""

    def __init__(self, tool_choice: Any = "auto") -> None:
        self.enabled = tool_choice != "none"
        self.forced_name: str | None = None
        if isinstance(tool_choice, dict):
            self.forced_name = (tool_choice.get("function") or {}).get("name")
        # A forced named call is also "required": plain content is not an
        # acceptable outcome.
        self.required = tool_choice == "required" or self.forced_name is not None

    def match(self, text: str) -> list[dict]:
        """Full generated text → list of tool_calls ([] = plain content).

        Accepts the bare JSON forms the reference accepts, plus the same
        JSON inside a ``` / ```json fence (models trained to emit fenced
        code do this constantly; the reference's engines strip fences
        before the matcher sees the text)."""
        if not self.enabled:
            return []
        s = text.strip()
        if s.startswith("```"):
            s = s.split("\n", 1)[-1] if "\n" in s else s[3:]
            s = s.rsplit("```", 1)[0].strip()
            if s.startswith("json"):
                s = s[4:].strip()
        try:
            obj = json.loads(s)
        except (json.JSONDecodeError, RecursionError):
            return []
        if isinstance(obj, dict):
            call = _called(obj, 0)
            calls = [call] if call else []
        elif isinstance(obj, list):
            parsed = [_called(o, i) for i, o in enumerate(obj)]
            calls = [c for c in parsed if c] if all(parsed) and parsed else []
        else:
            calls = []
        if self.forced_name is not None:
            calls = [
                c for c in calls
                if c["function"]["name"] == self.forced_name
            ]
            for i, c in enumerate(calls):
                c["index"] = i
        return calls
