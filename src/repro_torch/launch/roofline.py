"""Roofline terms of one NVIDIA H100, and the JAX package's HLO parsers
(``repro.launch.roofline``).

Terms (the card's rates, from NVIDIA's data sheets, by H100 variant;
dense, without sparsity):

    compute    = analytic FLOPs / (chips x bf16 tensor-core rate)
    memory     = analytic HBM bytes per card / device-memory rate
    collective = collective bytes / NVLink rate each way

The port compiles no XLA program, so the reference's collective bytes
have no source here: the dry-run keeps an empty :class:`CollectiveStats`
and says so.  The parsers ``collective_bytes_from_hlo`` and
``extrapolate_body`` and ``CollectiveStats.combine`` are copied as plain
Python over HLO text.  ``cost_analysis_dict`` reads no compiled object:
it counts the FLOPs of one call of a function with
``torch.utils.flop_counter.FlopCounterMode``.  The rate tables are the
one source of the card's rates for the port's bounds (``chip_smoke.py``
reads them here).
"""

from __future__ import annotations

import dataclasses
import re

#: device-memory rate by H100 variant, bytes/s (data sheets)
H100_BYTES_PER_S = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}
#: dense bf16 tensor-core rate by H100 variant, flop/s (data sheets)
H100_BF16_FLOPS = {"PCIe": 756e12, "NVL": 835e12, "SXM": 989e12}
#: fp32 rate of the CUDA cores (outside the tensor cores) by H100
#: variant, flop/s (data sheets)
H100_FP32_FLOPS = {"PCIe": 51e12, "NVL": 60e12, "SXM": 67e12}
#: NVLink to the other cards of a host, each way, bytes/s (SXM)
NVLINK_BYTES_PER_S = 450e9
#: the name ``torch.cuda.get_device_name`` gives the SXM part
H100_SXM = "NVIDIA H100 80GB HBM3"


def _variant_rate(name: str, table: dict, what: str) -> float:
    if "H100" not in name:
        raise RuntimeError(f"no {what} on record for {name!r}")
    for variant, rate in table.items():
        if variant in name:
            return rate
    return table["SXM"]   # "H100 80GB HBM3" is the SXM part


def memory_rate(name: str) -> float:
    """Device-memory bytes/s of the card named ``name``."""
    return _variant_rate(name, H100_BYTES_PER_S, "memory rate")


def bf16_rate(name: str) -> float:
    """Dense bf16 tensor-core flop/s of the card named ``name``."""
    return _variant_rate(name, H100_BF16_FLOPS, "bf16 rate")


def fp32_rate(name: str) -> float:
    """fp32 CUDA-core flop/s of the card named ``name``."""
    return _variant_rate(name, H100_FP32_FLOPS, "fp32 rate")


_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_TOKEN_RE = re.compile(
    r"\b(all-gather|all-reduce|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start)?\(")


def cost_analysis_dict(fn, *args, **kwargs) -> dict:
    """``{"flops": F}``: the FLOPs ``torch.utils.flop_counter`` counts in
    one call ``fn(*args, **kwargs)`` (matmuls, attention, convolutions;
    a multiply-add is 2; a backward the call runs is counted too), and
    ``"flops:<op>"`` per counted operator."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    by_op = counter.get_flop_counts().get("Global", {})
    out = {"flops": float(counter.get_total_flops())}
    out.update({f"flops:{op}": float(n) for op, n in by_op.items()})
    return out


def _shape_bytes(dtype: str, dims: str) -> int:
    if dtype not in _DTYPE_BYTES:
        return 0
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: int = 0
    by_op: dict = dataclasses.field(default_factory=dict)
    n_ops: int = 0

    def combine(self, other: "CollectiveStats", scale: float = 1.0
                ) -> "CollectiveStats":
        by_op = dict(self.by_op)
        for k, v in other.by_op.items():
            by_op[k] = by_op.get(k, 0) + int(v * scale)
        return CollectiveStats(
            total_bytes=self.total_bytes
            + int(other.total_bytes * scale),
            by_op=by_op,
            n_ops=self.n_ops + other.n_ops)


def collective_bytes_from_hlo(hlo_text: str) -> CollectiveStats:
    """Sum per-device payload bytes of every collective op instance of a
    partitioned HLO module's text: the result shape(s) between '=' and
    the op name (all-reduce: the operand; all-gather: the gathered
    buffer; reduce-scatter: the scattered shard).  Of an async pair
    only the ``-start`` counts."""
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        if "=" not in line or "-done(" in line:
            continue  # async pairs: count the -start only
        rhs = line.split("=", 1)[1]
        m = _OP_TOKEN_RE.search(rhs)
        if not m:
            continue
        op = m.group(1)
        head = rhs[: m.start()]  # result shape(s) precede the op name
        nbytes = sum(_shape_bytes(dt, dims)
                     for dt, dims in _SHAPE_RE.findall(head))
        stats.total_bytes += nbytes
        stats.n_ops += 1
        stats.by_op[op] = stats.by_op.get(op, 0) + nbytes
    return stats


def extrapolate_body(c1: CollectiveStats, c2: CollectiveStats,
                     n_super: int) -> CollectiveStats:
    """Scan-body correction: programs at 1 and 2 superblocks; (c2 - c1)
    is one body's collectives, so the full model is c1 + body *
    (n_super - 1)."""
    body = CollectiveStats(
        total_bytes=max(0, c2.total_bytes - c1.total_bytes),
        by_op={k: max(0, c2.by_op.get(k, 0) - c1.by_op.get(k, 0))
               for k in set(c1.by_op) | set(c2.by_op)},
        n_ops=max(0, c2.n_ops - c1.n_ops))
    return c1.combine(body, scale=float(n_super - 1))


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    analytic_gflops: float         # whole step, all chips (primary)
    analytic_hbm_gbytes_dev: float
    collective_gbytes: float       # per device
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_gflops: float            # 6*N_active*D (2*N for inference)
    useful_ratio: float            # model / analytic total
    roofline_fraction: float       # bound_time share vs sum of terms
    hlo_raw: dict                  # the FLOP counter's, where it ran
    bytes_per_device: dict
    collective_by_op: dict
    flops_by_part: dict
    bytes_by_part: dict
    note: str = ""

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def build_report(*, arch: str, shape: str, mesh_name: str, n_chips: int,
                 analytic, cost: dict | None = None,
                 mem: dict | None = None,
                 coll: CollectiveStats | None = None,
                 model_flops: float, note: str = "",
                 card: str = H100_SXM) -> RooflineReport:
    """analytic: ``launch.analytic.CostBreakdown`` (the compute and memory
    terms); the rates are the card's (``card``: a name as
    ``torch.cuda.get_device_name`` gives it); ``cost`` (None: ``{}``) is
    kept as ``hlo_raw``, ``coll`` (None: none) gives the collective
    term, as in the reference."""
    coll = CollectiveStats() if coll is None else coll
    compute_s = analytic.flops_total / n_chips / bf16_rate(card)
    memory_s = analytic.hbm_bytes_per_chip / memory_rate(card)
    collective_s = coll.total_bytes / NVLINK_BYTES_PER_S
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_chips=n_chips,
        analytic_gflops=analytic.flops_total / 1e9,
        analytic_hbm_gbytes_dev=analytic.hbm_bytes_per_chip / 1e9,
        collective_gbytes=coll.total_bytes / 1e9,
        compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, dominant=dominant,
        model_gflops=model_flops / 1e9,
        useful_ratio=(model_flops / analytic.flops_total
                      if analytic.flops_total else 0.0),
        roofline_fraction=(bound / max(sum(terms.values()), 1e-30)),
        hlo_raw={k: float(v) for k, v in (cost or {}).items()
                 if isinstance(v, (int, float))},
        bytes_per_device=mem or {}, collective_by_op=coll.by_op,
        flops_by_part=analytic.flops_by_part,
        bytes_by_part=analytic.bytes_by_part,
        note=note)


def model_flops_for(cfg, shape_cfg, n_params_active: int) -> float:
    """MODEL_FLOPS: 6*N*D for training (fwd+bwd), 2*N*D for inference
    fwd; D = processed tokens for the step being lowered."""
    if shape_cfg.kind == "train":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        if cfg.family == "audio":
            tokens = shape_cfg.global_batch * (
                shape_cfg.seq_len + max(128, shape_cfg.seq_len // 4))
        return 6.0 * n_params_active * tokens
    if shape_cfg.kind == "prefill":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 2.0 * n_params_active * tokens
    # decode: one token per sequence
    return 2.0 * n_params_active * shape_cfg.global_batch
