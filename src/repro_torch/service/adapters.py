"""Framework adapters: the paper's "thin adapter layer" (contribution 5).

The reference CCS implementation "integrates with LangGraph, CrewAI and
AutoGen via thin adapter layers" - thin because the coherence decision
lives entirely in the broker; an adapter only reshapes read/write calls
into the host framework's tool calling convention.  None of these
frameworks are (or may be) installed here, so each shim is duck-typed
to the framework's documented surface and works standalone:

  * :class:`CoherentTool` - framework-neutral callable + an
    OpenAI-style function schema (``.spec``), the shape both CrewAI
    and AutoGen ultimately consume;
  * :func:`langgraph_node` - an async ``state -> partial-state`` node
    function (LangGraph nodes are exactly that signature);
  * :func:`crewai_tool` - an object exposing ``name`` /
    ``description`` / ``run(...)`` (CrewAI's ``BaseTool`` protocol);
  * :func:`autogen_functions` - ``(schemas, function_map)`` matching
    AutoGen's ``llm_config["functions"]`` + ``register_function``
    pattern.

Sync frameworks get a ``SyncCoherentClient`` (via
``client.ServicePortal``); async frameworks can pass a plain
``CoherentClient``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

from repro_torch.service.client import CoherentClient, SyncCoherentClient

AnyClient = Union[CoherentClient, SyncCoherentClient]

TOOL_NAME = "shared_artifact"
TOOL_DESCRIPTION = (
    "Read or write a shared artifact through the coherence broker. "
    "Reads are free when your cached copy is still coherent; writes "
    "serialize through the authority and invalidate peer copies.")

#: OpenAI-style JSON-schema for the tool call, the least common
#: denominator the three frameworks all accept.
TOOL_PARAMETERS = {
    "type": "object",
    "properties": {
        "operation": {"type": "string", "enum": ["read", "write"]},
        "artifact": {"type": "string",
                     "description": "artifact id, e.g. 'plan'"},
        "content": {
            "type": "string",
            "description": "new artifact content (write only)"},
    },
    "required": ["operation", "artifact"],
}


def encode_content(content: Union[str, Sequence[int]],
                   artifact_tokens: int) -> list:
    """Fixed-slot token encoding: int sequences pass through; strings
    become their UTF-8 bytes.  Either is padded/truncated to the
    broker's fixed ``artifact_tokens`` slot (the broker accounts whole
    slots, like the simulator)."""
    toks = (list(content.encode("utf-8")) if isinstance(content, str)
            else [int(t) for t in content])
    toks = toks[:artifact_tokens]
    return toks + [0] * (artifact_tokens - len(toks))


def _is_async(client: AnyClient) -> bool:
    return isinstance(client, CoherentClient)


@dataclasses.dataclass
class ToolResult:
    """Framework-neutral result envelope."""

    operation: str
    artifact: str
    version: int
    hit: Optional[bool]      # None for writes
    content: Optional[tuple]  # None for writes

    def as_text(self) -> str:
        """LLM-facing rendering (what a tool call returns to the model)."""
        if self.operation == "write":
            return (f"wrote {self.artifact!r}; committed version "
                    f"{self.version}")
        src = "coherent cache" if self.hit else "authority fetch"
        return (f"{self.artifact!r} v{self.version} ({src}): "
                f"{list(self.content[:16])}...")


class CoherentTool:
    """Framework-neutral coherent-artifact tool.

    Call synchronously with a :class:`SyncCoherentClient`, or
    ``await tool.acall(...)`` with an async :class:`CoherentClient`.
    """

    name = TOOL_NAME
    description = TOOL_DESCRIPTION

    def __init__(self, client: AnyClient) -> None:
        self.client = client
        self._tokens = client_broker(client).config.artifact_tokens

    @property
    def spec(self) -> dict:
        """OpenAI-style function-call schema."""
        return {"name": self.name, "description": self.description,
                "parameters": TOOL_PARAMETERS}

    # ------------------------------------------------------------ sync
    def __call__(self, operation: str, artifact: str,
                 content: Union[str, Sequence[int], None] = None
                 ) -> ToolResult:
        if _is_async(self.client):
            raise TypeError(
                "CoherentTool over an async CoherentClient must be "
                "awaited via .acall(); hand it a "
                "ServicePortal.client(...) for sync frameworks")
        if operation == "read":
            r = self.client.read(artifact)
            return ToolResult("read", artifact, r.version, r.hit,
                              r.content)
        if operation == "write":
            toks = (encode_content(content, self._tokens)
                    if content is not None else None)
            w = self.client.write(artifact, toks)
            return ToolResult("write", artifact, w.version, None, None)
        raise ValueError(f"operation must be read|write, got "
                         f"{operation!r}")

    # ----------------------------------------------------------- async
    async def acall(self, operation: str, artifact: str,
                    content: Union[str, Sequence[int], None] = None
                    ) -> ToolResult:
        if operation == "read":
            r = await _areader(self.client)(artifact)
            return ToolResult("read", artifact, r.version, r.hit,
                              r.content)
        if operation == "write":
            toks = (encode_content(content, self._tokens)
                    if content is not None else None)
            w = await _awriter(self.client)(artifact, toks)
            return ToolResult("write", artifact, w.version, None, None)
        raise ValueError(f"operation must be read|write, got "
                         f"{operation!r}")


def client_broker(client: AnyClient):
    return (client.broker if _is_async(client)
            else client.portal.broker)


def _guard_sync_on_portal_loop(client) -> None:
    """A sync (portal) client called from a coroutine that runs ON the
    portal's own loop would block that loop while waiting for itself -
    a guaranteed deadlock.  Fail fast with the fix instead."""
    import asyncio
    try:
        running = asyncio.get_running_loop()
    except RuntimeError:
        return
    if running is client.portal._loop:
        raise TypeError(
            "sync portal client awaited on the portal's own event loop "
            "- this deadlocks.  Inside portal-loop coroutines use an "
            "async CoherentClient(portal.broker, ...) instead")


def _areader(client):
    if _is_async(client):
        return client.read

    async def read(artifact):
        _guard_sync_on_portal_loop(client)
        return client.read(artifact)
    return read


def _awriter(client):
    if _is_async(client):
        return client.write

    async def write(artifact, content):
        _guard_sync_on_portal_loop(client)
        return client.write(artifact, content)
    return write


# ---------------------------------------------------------------------------
# LangGraph-style adapter.


def langgraph_node(client: AnyClient, reads: Sequence[str] = (),
                   name: str = "coherent_artifacts"):
    """A LangGraph-style node: ``async (state: dict) -> dict`` update.

    Writes every entry of ``state['artifact_updates']`` (a
    ``{artifact: content}`` dict) through the broker, then reads
    ``reads`` (or ``state['artifact_reads']``) into
    ``state['artifacts']``.  Wire it into a graph exactly like any
    other node - the coherence layer decides whether each read costs
    tokens."""

    async def node(state: dict) -> dict:
        tool = CoherentTool(client)
        versions = {}
        for artifact, content in (state.get("artifact_updates")
                                  or {}).items():
            res = await tool.acall("write", artifact, content)
            versions[artifact] = res.version
        artifacts = {}
        hits = {}
        for artifact in (reads or state.get("artifact_reads") or ()):
            res = await tool.acall("read", artifact)
            artifacts[artifact] = res.content
            versions[artifact] = res.version
            hits[artifact] = res.hit
        return {"artifacts": artifacts, "artifact_versions": versions,
                "artifact_hits": hits}

    node.__name__ = name
    return node


# ---------------------------------------------------------------------------
# CrewAI-style adapter.


class CrewAIToolShim:
    """Duck-typed CrewAI ``BaseTool``: ``name``, ``description``,
    ``run(**kwargs)`` (and the ``_run`` alias newer versions call)."""

    def __init__(self, client: SyncCoherentClient) -> None:
        self._tool = CoherentTool(client)
        self.name = TOOL_NAME
        self.description = TOOL_DESCRIPTION
        self.args_schema = TOOL_PARAMETERS

    def run(self, operation: str, artifact: str,
            content: Union[str, Sequence[int], None] = None) -> str:
        return self._tool(operation, artifact, content).as_text()

    _run = run


def crewai_tool(client: SyncCoherentClient) -> CrewAIToolShim:
    """CrewAI-style tool over a sync (portal) client."""
    if _is_async(client):
        raise TypeError("CrewAI runs synchronous tools - pass a "
                        "ServicePortal.client(...) instead")
    return CrewAIToolShim(client)


# ---------------------------------------------------------------------------
# AutoGen-style adapter.


def autogen_functions(client: AnyClient):
    """AutoGen-style registration pair: ``(schemas, function_map)``.

    ``schemas`` plugs into ``llm_config["functions"]``; ``function_map``
    into ``UserProxyAgent.register_function``.  With an async client the
    mapped callables are coroutine functions (AutoGen supports async
    function maps); with a portal client they are plain callables."""
    tool = CoherentTool(client)
    schemas = [
        {"name": "read_artifact",
         "description": "Read a shared artifact (coherence-cached).",
         "parameters": {
             "type": "object",
             "properties": {"artifact": {"type": "string"}},
             "required": ["artifact"]}},
        {"name": "write_artifact",
         "description": "Commit new content to a shared artifact.",
         "parameters": {
             "type": "object",
             "properties": {"artifact": {"type": "string"},
                            "content": {"type": "string"}},
             "required": ["artifact", "content"]}},
    ]
    if _is_async(client):
        async def read_artifact(artifact: str) -> str:
            return (await tool.acall("read", artifact)).as_text()

        async def write_artifact(artifact: str, content: str) -> str:
            return (await tool.acall("write", artifact,
                                     content)).as_text()
    else:
        def read_artifact(artifact: str) -> str:
            return tool("read", artifact).as_text()

        def write_artifact(artifact: str, content: str) -> str:
            return tool("write", artifact, content).as_text()
    return schemas, {"read_artifact": read_artifact,
                     "write_artifact": write_artifact}
