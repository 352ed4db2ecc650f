"""Concurrent load generator driving the broker with workload-zoo rates.

Each agent of a ``repro_torch.sim.workloads.Workload`` becomes one concurrent
async client; actions are sampled per *round* from the workload's rate
matrices (activity Bernoulli, categorical artifact pick, conditional
write Bernoulli) with a seeded numpy generator.

Two drive modes:

  * ``lockstep=True`` - rounds are barriers: every client of a round
    submits concurrently, the round's decisions resolve, then the next
    round starts.  A round is one orchestration step in the paper's
    SS8.1 sense, which makes the broadcast baseline exact
    (``n_rounds * n * m * (|d| + signal)``) and the coherent token
    totals deterministic for a fixed seed - the mode the benchmark and
    the perf gate use.
  * ``lockstep=False`` - open loop: every client runs its own round
    schedule with optional jittered think-time sleeps, so batches cut
    across rounds at the event loop's mercy.  Nothing is deterministic
    except what must be: the invariants and the oracle-replay of
    whatever trace was actually committed.  The concurrency stress
    tests use this mode.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.core.acs import SIGNAL_TOKENS
from repro_torch.service.broker import CoherenceBroker
from repro_torch.service.client import CoherentClient, make_clients


@dataclasses.dataclass
class LoadReport:
    """What the generated load did and what it cost."""

    n_rounds: int
    n_actions: int
    n_reads: int
    n_writes: int
    wall_s: float
    latencies_s: np.ndarray
    broadcast_tokens: int     # what per-round full rebroadcast would pay
    coherent_tokens: int      # what the broker actually charged
    #: per-authority-shard seconds spent inside the decider (length 1
    #: for the single broker).  The decision plane's makespan is the
    #: MAX entry: shards decide concurrently under the shard-per-host
    #: deployment, so capacity scales with the slowest shard, not the
    #: sum.
    decide_busy_s: tuple = (0.0,)

    @property
    def throughput_dps(self) -> float:
        """Decisions per second, end to end."""
        return self.n_actions / max(self.wall_s, 1e-9)

    @property
    def capacity_dps(self) -> float:
        """Decision capacity: decisions per second of decision-plane
        makespan (max busy time over authority shards).  Unlike
        ``throughput_dps`` this is host-count independent - it measures
        what the authority plane itself can serialize, which is the
        quantity sharding scales."""
        return self.n_actions / max(max(self.decide_busy_s), 1e-9)

    @property
    def savings_vs_broadcast(self) -> float:
        return 1.0 - self.coherent_tokens / max(self.broadcast_tokens, 1)

    def latency_ms(self, pct: float) -> float:
        if self.latencies_s.size == 0:
            return 0.0
        return float(np.percentile(self.latencies_s, pct) * 1e3)


def sample_round(rng: np.random.Generator, workload) -> list:
    """One round of (agent, artifact, is_write) actions from the
    workload's rate matrices."""
    n = workload.acs.n_agents
    p_act = np.asarray(workload.p_act, np.float64)
    pick = np.asarray(workload.pick, np.float64)
    wr = np.asarray(workload.write_rate, np.float64)
    actions = []
    for a in range(n):
        if rng.random() >= p_act[a]:
            continue
        d = int(rng.choice(pick.shape[1], p=pick[a] / pick[a].sum()))
        actions.append((a, d, bool(rng.random() < wr[a, d])))
    return actions


async def drive_workload(broker: CoherenceBroker, workload,
                         n_rounds: int, seed: int = 0, *,
                         lockstep: bool = True,
                         think_time_s: float = 0.0,
                         clients: Optional[list] = None) -> LoadReport:
    """Drive ``broker`` with ``workload``'s rates for ``n_rounds``."""
    clients = clients if clients is not None else make_clients(broker)
    if len(clients) != workload.acs.n_agents:
        raise ValueError(
            f"{len(clients)} clients vs workload n_agents="
            f"{workload.acs.n_agents}")
    names = broker.names
    if len(names) != workload.acs.n_artifacts:
        raise ValueError(
            f"broker has {len(names)} artifacts vs workload "
            f"n_artifacts={workload.acs.n_artifacts}")
    rng = np.random.default_rng(seed)
    schedule = [sample_round(rng, workload) for _ in range(n_rounds)]

    def busy() -> tuple:
        if hasattr(broker, "decision_busy"):    # sharded plane
            return tuple(broker.decision_busy())
        return (broker.decide_busy_s,)

    busy_before = busy()
    tok_before = broker.ledger.total_tokens
    lat: list = []
    n_reads = n_writes = 0

    async def one_action(client: CoherentClient, d: int, is_write: bool,
                         jitter: float) -> None:
        if jitter > 0:
            await asyncio.sleep(jitter)
        if is_write:
            res = await client.write(names[d])
        else:
            res = await client.read(names[d])
        lat.append(res.latency_s)

    t0 = time.perf_counter()
    if lockstep:
        for actions in schedule:
            await asyncio.gather(*(
                one_action(clients[a], d, w, 0.0)
                for a, d, w in actions))
    else:
        async def client_script(a: int) -> None:
            crng = np.random.default_rng((seed, a))
            for actions in schedule:
                for aa, d, w in actions:
                    if aa != a:
                        continue
                    jitter = (float(crng.random()) * think_time_s
                              if think_time_s > 0 else 0.0)
                    await one_action(clients[a], d, w, jitter)

        await asyncio.gather(*(client_script(a)
                               for a in range(len(clients))))
    wall = time.perf_counter() - t0

    for actions in schedule:
        for _, _, w in actions:
            n_writes += int(w)
            n_reads += int(not w)
    n, m = workload.acs.n_agents, workload.acs.n_artifacts
    broadcast = n_rounds * n * m * (workload.acs.artifact_tokens
                                    + SIGNAL_TOKENS)
    return LoadReport(
        n_rounds=n_rounds, n_actions=n_reads + n_writes,
        n_reads=n_reads, n_writes=n_writes, wall_s=wall,
        latencies_s=np.asarray(lat, np.float64),
        broadcast_tokens=broadcast,
        coherent_tokens=broker.ledger.total_tokens - tok_before,
        decide_busy_s=tuple(b - b0 for b, b0
                            in zip(busy(), busy_before)))
