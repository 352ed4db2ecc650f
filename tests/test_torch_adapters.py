"""The port's framework adapters (``repro_torch.service.adapters``)
against the JAX package's: the same tool name, description and schema,
the same content encoding, and the same ``ToolResult``s from the
LangGraph, CrewAI and AutoGen shims over a port portal (on the CPU) and
a reference portal, for one scripted sequence."""

import asyncio
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro import service as rservice  # noqa: E402
from repro.service import adapters as radapters  # noqa: E402
from repro_torch import service  # noqa: E402
from repro_torch.service import adapters  # noqa: E402

pytestmark = pytest.mark.torch

CPU = {"device": "cpu"}
NAMES = tuple(f"artifact-{d}" for d in range(3))


def test_tool_surface_equals_the_reference():
    assert adapters.TOOL_NAME == radapters.TOOL_NAME
    assert adapters.TOOL_DESCRIPTION == radapters.TOOL_DESCRIPTION
    assert adapters.TOOL_PARAMETERS == radapters.TOOL_PARAMETERS
    cfg = service.CoherenceConfig.make(2, NAMES, artifact_tokens=16)
    rcfg = rservice.CoherenceConfig.make(2, NAMES, artifact_tokens=16)
    with service.ServicePortal(cfg, **CPU) as portal, \
            rservice.ServicePortal(rcfg) as rportal:
        tool = service.CoherentTool(portal.client(0))
        rtool = rservice.CoherentTool(rportal.client(0))
        assert tool.spec == rtool.spec
        shim = service.crewai_tool(portal.client(1))
        rshim = rservice.crewai_tool(rportal.client(1))
        assert ((shim.name, shim.description, shim.args_schema)
                == (rshim.name, rshim.description, rshim.args_schema))
        schemas, fmap = service.autogen_functions(portal.client(1))
        rschemas, rfmap = rservice.autogen_functions(rportal.client(1))
        assert schemas == rschemas and set(fmap) == set(rfmap)


@pytest.mark.parametrize("content,tokens", [
    ("hello coherence", 32), ("héllo ✓", 8), ("x" * 40, 16), ("", 4),
    ([1, 2, 3], 5), (list(range(20)), 8), ((7, 8), 2)])
def test_encode_content_equals_the_reference(content, tokens):
    got = adapters.encode_content(content, tokens)
    assert got == radapters.encode_content(content, tokens)
    assert len(got) == tokens


def _script(package, portal) -> list:
    """One scripted sequence through every shim; returns each call's
    ``ToolResult`` (as a tuple) or text."""
    out = []
    tool = package.CoherentTool(portal.client(0))
    for call in (("write", "artifact-0", "plan v2"), ("read", "artifact-0"),
                 ("write", "artifact-1", [5, 6, 7]), ("read", "artifact-2")):
        out.append(dataclasses.astuple(tool(*call)))
    crew = package.crewai_tool(portal.client(1))
    out += [crew.run("read", "artifact-0"),
            crew.run("write", "artifact-0", "crew edit"),
            crew._run("read", "artifact-0")]
    _, fmap = package.autogen_functions(portal.client(2))
    out += [fmap["read_artifact"]("artifact-0"),
            fmap["write_artifact"]("artifact-2", "autogen notes"),
            fmap["read_artifact"]("artifact-2")]
    node = package.langgraph_node(
        package.CoherentClient(portal.broker, 3),
        reads=("artifact-0", "artifact-2"))
    update = portal.call(node({"artifact_updates": {"artifact-1": "graph"}}))
    out.append(update)
    aclient = package.CoherentClient(portal.broker, 1)
    _, afmap = package.autogen_functions(aclient)
    out.append(portal.call(afmap["read_artifact"]("artifact-1")))
    atool = package.CoherentTool(aclient)
    out.append(dataclasses.astuple(
        portal.call(atool.acall("write", "artifact-1", "async"))))
    return out


@pytest.mark.parametrize("topology", [{}, {"shards": 2, "hosts": 2}],
                         ids=["single", "sharded"])
def test_shims_give_the_reference_results(topology):
    cfg = service.CoherenceConfig.make(4, NAMES, artifact_tokens=32,
                                       **topology)
    rcfg = rservice.CoherenceConfig.make(4, NAMES, artifact_tokens=32,
                                         **topology)
    with service.ServicePortal(cfg, **CPU) as portal:
        got = _script(service, portal)
        assert (type(portal.broker).__name__ == "ShardedCoherenceBroker"
                ) == bool(topology)
        service.verify_broker(portal.broker, name="adapters")
    with rservice.ServicePortal(rcfg) as rportal:
        want = _script(rservice, rportal)
    assert got == want
    assert any("coherent cache" in t for t in got if isinstance(t, str))
    assert any("authority fetch" in t for t in got if isinstance(t, str))


def _raises(fn) -> tuple:
    with pytest.raises(TypeError) as info:
        fn()
    return str(info.value)


def test_async_client_guards_raise_as_in_the_reference():
    async def main(package, **opts):
        cfg = package.CoherenceConfig.make(2, NAMES, artifact_tokens=16)
        async with package.connect(cfg, **opts) as broker:
            client = package.CoherentClient(broker, 0)
            tool = package.CoherentTool(client)
            msgs = [_raises(lambda: tool("read", "artifact-0")),
                    _raises(lambda: package.crewai_tool(client))]
            res = await tool.acall("read", "artifact-0")
            return msgs, dataclasses.astuple(res)

    assert asyncio.run(main(service, **CPU)) == asyncio.run(main(rservice))

    def on_portal_loop(package, portal):
        tool = package.CoherentTool(portal.client(0))

        async def inside():
            with pytest.raises(TypeError) as info:
                await tool.acall("read", "artifact-0")
            return str(info.value)
        return portal.call(inside())

    cfg = service.CoherenceConfig.make(2, NAMES, artifact_tokens=16)
    rcfg = rservice.CoherenceConfig.make(2, NAMES, artifact_tokens=16)
    with service.ServicePortal(cfg, **CPU) as portal, \
            rservice.ServicePortal(rcfg) as rportal:
        msg = on_portal_loop(service, portal)
        assert "deadlocks" in msg
        assert msg == on_portal_loop(rservice, rportal)
