"""Per-agent clients of the coherence broker.

``CoherentClient`` is the async-native client (one per agent slot).
``ServicePortal`` hosts a broker on a background-thread event loop and
hands out ``SyncCoherentClient``s, so *synchronous* frameworks (the
CrewAI-style adapter, plain scripts, REPLs) can call the async broker
without owning an event loop - the portal is what makes the paper's
"thin adapter layer" thin.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Optional, Sequence

from repro_torch.content.chunks import apply_delta
from repro_torch.service.broker import (BrokerConfig, CoherenceBroker,
                                        ReadResult, WriteResult)


class DeltaMismatch(AssertionError):
    """A delta-patched mirror diverged from the authority copy."""


def _chunk_tokens(config) -> int:
    """Chunk granularity of a flat BrokerConfig or a layered
    CoherenceConfig (clients serve both broker flavors)."""
    core = getattr(config, "core", None)
    return core.chunk_tokens if core is not None else config.chunk_tokens


class CoherentClient:
    """One agent's handle on the broker (async).

    Against a *chunked* broker the client keeps a local mirror per
    artifact and patches it with each read's delta payload
    (``repro_torch.content.apply_delta``) - the client-side half of delta
    coherence.  Every patched mirror is checked byte-for-byte against
    the authority copy the response carries; a mismatch raises
    :class:`DeltaMismatch` (it would mean the broker shipped an
    incomplete stale-chunk set).
    """

    def __init__(self, broker: CoherenceBroker, agent_id: int,
                 name: Optional[str] = None) -> None:
        self.broker = broker
        self.agent_id = int(agent_id)
        self.name = name or f"agent-{agent_id}"
        self.n_reads = 0
        self.n_writes = 0
        self.n_hits = 0
        self._mirror: dict = {}
        self.delta_bytes_received = 0

    def _patch_mirror(self, artifact: str, res: ReadResult) -> None:
        if res.delta is None:
            return
        ct = _chunk_tokens(self.broker.config)
        base = self._mirror.get(artifact)
        if base is None:
            # first contact: adopt the full copy (the broker charged a
            # cold full-artifact delta for it anyway)
            self._mirror[artifact] = res.content
        else:
            self._mirror[artifact] = apply_delta(base, res.delta, ct)
        if res.delta_bytes > 0:
            self.delta_bytes_received += res.delta_bytes
        if self._mirror[artifact] != res.content:
            raise DeltaMismatch(
                f"agent {self.agent_id}: delta-patched mirror of "
                f"{artifact!r} diverged from the authority copy")

    async def read(self, artifact: str) -> ReadResult:
        res = await self.broker.read(self.agent_id, artifact)
        self.n_reads += 1
        self.n_hits += int(res.hit)
        self._patch_mirror(artifact, res)
        return res

    async def write(self, artifact: str,
                    content: Optional[Sequence[int]] = None
                    ) -> WriteResult:
        res = await self.broker.write(self.agent_id, artifact, content)
        self.n_writes += 1
        if content is not None:
            # the writer holds what it just committed
            self._mirror[artifact] = tuple(int(t) for t in content)
        return res

    @property
    def hit_rate(self) -> float:
        return self.n_hits / max(self.n_reads, 1)


def make_clients(broker: CoherenceBroker) -> list:
    """One client per agent slot of the broker."""
    return [CoherentClient(broker, a)
            for a in range(broker.config.n_agents)]


# ---------------------------------------------------------------------------
# Sync bridge for frameworks that do not run an event loop.


class ServicePortal:
    """Owns an event loop on a daemon thread and runs a broker on it.

    Synchronous code (framework tool callbacks, scripts) submits
    coroutines with :meth:`call`; concurrency still happens - requests
    from many threads coalesce into the broker's micro-batches on the
    portal loop.  Use as a context manager::

        with ServicePortal(config) as portal:
            client = portal.client(0)
            client.read("plan")

    The broker's directory lives on ``device`` (``None``: CUDA).
    """

    _CALL_TIMEOUT_S = 60.0

    def __init__(self, config: BrokerConfig,
                 contents: Optional[dict] = None, *, device=None) -> None:
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, name="coherence-broker",
            daemon=True)
        self._thread.start()
        try:
            self.broker = self.call(self._make_broker(config, contents,
                                                      device))
        except BaseException:
            self._stop_loop()       # no broker: end the loop's thread
            raise

    @staticmethod
    async def _make_broker(config, contents, device):
        # topology-neutral: a layered config with shards/hosts gets the
        # sharded authority plane, anything else the single broker
        from repro_torch.service.connect import resolve_broker
        return await resolve_broker(config, contents,
                                    device=device).start()

    # ---------------------------------------------------------------
    def call(self, coro):
        """Run a coroutine on the portal loop, blocking for the result."""
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        return fut.result(timeout=self._CALL_TIMEOUT_S)

    def client(self, agent_id: int,
               name: Optional[str] = None) -> "SyncCoherentClient":
        return SyncCoherentClient(self, agent_id, name=name)

    def close(self) -> None:
        if self._loop.is_closed():
            return
        self.call(self.broker.stop())
        self._stop_loop()

    def _stop_loop(self) -> None:
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=self._CALL_TIMEOUT_S)
        self._loop.close()

    def __enter__(self) -> "ServicePortal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class SyncCoherentClient:
    """Blocking per-agent client backed by a :class:`ServicePortal`."""

    def __init__(self, portal: ServicePortal, agent_id: int,
                 name: Optional[str] = None) -> None:
        self.portal = portal
        self._async = CoherentClient(portal.broker, agent_id, name=name)
        self.agent_id = self._async.agent_id
        self.name = self._async.name

    def read(self, artifact: str) -> ReadResult:
        return self.portal.call(self._async.read(artifact))

    def write(self, artifact: str,
              content: Optional[Sequence[int]] = None) -> WriteResult:
        return self.portal.call(self._async.write(artifact, content))

    @property
    def hit_rate(self) -> float:
        return self._async.hit_rate
