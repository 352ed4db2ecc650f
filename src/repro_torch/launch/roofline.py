"""Roofline terms of one NVIDIA H100, the one-card part of the JAX
package's ``repro.launch.roofline``.

Terms (the card's rates, from NVIDIA's data sheets, by H100 variant;
dense, without sparsity):

    compute    = analytic FLOPs / (chips x bf16 tensor-core rate)
    memory     = analytic HBM bytes per card / device-memory rate
    collective = collective bytes / NVLink rate each way

On one card there is no collective, so that term is 0 (an empty
:class:`CollectiveStats`), and no compiled program to take a raw cost
analysis from, so ``hlo_raw`` is ``{}``.  The reference's HLO parsers
(``cost_analysis_dict``, ``collective_bytes_from_hlo``,
``extrapolate_body``) have meaning only across devices and are not
here.  The rate tables are the one source of the card's rates for the
port's bounds (``chip_smoke.py`` reads them here).
"""

from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: int = 0
    by_op: dict = dataclasses.field(default_factory=dict)
    n_ops: int = 0


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
    hlo_raw: dict                  # {} on one card: no compiled program
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
