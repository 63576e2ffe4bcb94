"""Roofline analysis over the port's dry-run reports — the JAX package's
``launch/roofline.py`` for one NVIDIA H100.

Per (arch x shape x mesh) cell, three per-step time lower bounds on the
card:

  compute    = FLOPs per device / peak FLOP/s   (989e12, dense bf16)
  memory     = resident bytes per device / HBM bandwidth   (3.35e12 B/s)
  collective = link bytes per device / link rate   (450e9 B/s)

The peaks are NVIDIA's data sheet for the H100 SXM (80 GB HBM3) at its
full 700 W power limit; a card set below 700 W runs slower under load, so
a bound read beside a measurement names the card's limit too. The link
rate is the same data sheet's NVLink 4 figure, 900 GB/s a card in both
directions together, so 450 GB/s each way: a data-sheet figure, not a
measurement (none of the TPU's rates carry over). The link bytes are the
dry run's collective bytes per device, an all-reduce counted 2x (a ring's
reduce-scatter and all-gather), as the JAX package counts them. The term
leaves out what a 256-card mesh adds: NVLink joins the 8 cards of one
node, and the rest cross the nodes' network at a fraction of that rate;
the hops and latency of each collective; and any overlap with compute.
The four-card cell of the port's benchmark (ROADMAP A8) measures a link.
``peak_hbm_gb`` is the dry run's ``memory["peak_bytes"]`` per device.

Sources (:mod:`.dryrun`): the step's FLOPs as
``torch.utils.flop_counter.FlopCounterMode`` counts them on the ``meta``
device (matrix products and attention; elementwise work is not counted),
depth-corrected by the 2- and 3-group probes; the bytes per device of the
parameters, optimizer state, cache and batch under the mesh's shardings,
each read once (a lower bound: the step reads the weights at least once).
The recurrent layers' inner time loops are added analytically
(:func:`ssm_inner_residual_flops`), as in the JAX package.

MODEL_FLOPS = 6*N*D (train, dense), 6*N_active*D (MoE), 2*N_active*tokens
(prefill; decode adds attention over the cache); the ratio MODEL_FLOPS /
counted FLOPs exposes remat and redundancy.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional

from ..configs import get_config
from ..models import model_schema, schema as schema_mod
from ..models.config import SHAPES

#: the card the bounds are for, with the power limit the peaks assume
CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS = 989e12          # dense bf16 per card (tensor cores)
HBM_BW = 3.35e12             # bytes/s per card
#: NVLink 4 of the H100 SXM (NVIDIA's data sheet: 900 GB/s a card, both
#: directions together), bytes/s each way
LINK_BW = 450e9

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"


def active_params(cfg) -> int:
    """Parameters touched per token (MoE counts top-k experts only)."""
    total = schema_mod.count_params(model_schema(cfg))
    if not cfg.moe_experts:
        return total
    period = cfg.pattern_period
    n_groups = cfg.n_layers // period
    from ..models.moe import moe_schema
    per_layer_moe = schema_mod.count_params(moe_schema(cfg)) // 1
    n_moe_layers = sum(cfg.layer_is_moe(j) for j in range(period)) * n_groups
    moe_total = per_layer_moe * n_moe_layers
    dense = total - moe_total
    active_moe = moe_total * cfg.moe_topk / cfg.moe_experts
    return int(dense + active_moe)


def model_flops(cfg, shape) -> float:
    """Analytic 'useful' FLOPs for the whole step (global, all devices)."""
    n_act = active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_act * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_act * tokens
    # decode: one token per sequence + attention over the cache
    tokens = shape.global_batch * 1
    n_attn = sum(1 for j in range(cfg.pattern_period)
                 if cfg.layer_pattern[j] == "attn")
    n_attn *= cfg.n_layers // cfg.pattern_period
    attn = 4.0 * n_attn * cfg.n_heads * cfg.hd * shape.seq_len * tokens
    return 2.0 * n_act * tokens + attn


def ssm_inner_residual_flops(cfg, shape, devices: int) -> float:
    """Per-device FLOPs of inner time loops the probes cannot see."""
    if shape.kind == "decode":
        return 0.0
    tokens = shape.global_batch * shape.seq_len
    period = cfg.pattern_period
    n_groups = cfg.n_layers // period
    total = 0.0
    fb = 3.0 if shape.kind == "train" else 1.0   # fwd+bwd multiplier
    for j in range(period):
        kind = cfg.layer_pattern[j]
        if kind == "mamba":
            di = cfg.mamba_expand * cfg.d_model
            # h_all = a*h + b per element over the carry path
            total += 3.0 * tokens * di * cfg.mamba_d_state * n_groups * fb
        elif kind == "slstm":
            d = cfg.d_model
            # recurrent matmul R (D x 4D) each step + gates
            total += (2.0 * tokens * d * 4 * d + 30.0 * tokens * d) \
                * n_groups * fb
        elif kind == "mlstm":
            d = cfg.d_model
            chunk = 128
            # intra-chunk (c x c) attention-like terms
            total += (4.0 * tokens * chunk * d) * n_groups * fb
    return total / devices


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    flops_device: float
    useful_ratio: float
    bound_frac: float           # compute_s / max(all three)
    resident_gb: float
    peak_hbm_gb: float
    card: str = CARD
    note: str = ""


def link_bytes(collective_bytes: dict) -> float:
    """Bytes a device moves over its links for the dry run's collective
    bytes: an all-reduce 2x its payload (reduce-scatter + all-gather), the
    others 1x."""
    return sum(v * (2.0 if op == "all-reduce" else 1.0)
               for op, v in collective_bytes.items())


def analyze(report: dict) -> Optional[Roofline]:
    """The bounds of one :func:`~repro_torch.launch.dryrun.lower_cell`
    report (None for a skipped or failed cell)."""
    if report.get("skipped") or "error" in report:
        return None
    cfg = get_config(report["arch"])
    shape = SHAPES[report["shape"]]
    dev = report["devices"]
    flops_dev = report["flops"] / dev + ssm_inner_residual_flops(cfg, shape,
                                                                 dev)
    bytes_dev = report["bytes_per_device"]["total"]
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = link_bytes(report["collective_bytes"]) / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    useful = mf / dev / flops_dev if flops_dev else 0.0
    return Roofline(
        arch=report["arch"], shape=report["shape"], mesh=report["mesh"],
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=mf, flops_device=flops_dev,
        useful_ratio=useful,
        bound_frac=compute_s / max(max(terms.values()), 1e-30),
        resident_gb=bytes_dev / 1e9,
        peak_hbm_gb=report["memory"]["peak_bytes"] / 1e9,
        note="; ".join(f"{k} replicated ({v})" for k, v in
                       report.get("replicated_fallbacks", {}).items()))


def load_all(tag: str = "", results_dir: Path = RESULTS_DIR
             ) -> Dict[str, dict]:
    """The dry-run reports; tag='' returns ONLY untagged baselines."""
    out = {}
    prefix = f"{tag}_" if tag else ""
    for f in sorted(Path(results_dir).glob(f"{prefix}*.json")):
        rep = json.loads(f.read_text())
        if (rep.get("tag") or "") != tag:
            continue
        out[f.stem] = rep
    return out


def table(mesh: str = "single", tag: str = "",
          results_dir: Path = RESULTS_DIR) -> str:
    rows = [f"| arch | shape | compute s | memory s | collective s "
            f"| dominant | MODEL/counted | roofline frac | resident GB/dev "
            f"| peak GB/dev | ({CARD}) |",
            "|" + "---|" * 11]
    for rep in load_all(tag, results_dir).values():
        if rep.get("mesh") != mesh:
            continue
        r = analyze(rep)
        if r is None:
            status = rep.get("reason", rep.get("error", "?"))[:40]
            rows.append(f"| {rep.get('arch')} | {rep.get('shape')} | - | - "
                        f"| - | {status} | - | - | - | - | |")
            continue
        rows.append(
            f"| {r.arch} | {r.shape} | {r.compute_s:.3e} | {r.memory_s:.3e} "
            f"| {r.collective_s:.3e} | **{r.dominant}** "
            f"| {r.useful_ratio:.2f} | {r.bound_frac:.2f} "
            f"| {r.resident_gb:.1f} | {r.peak_hbm_gb:.1f} | {r.note} |")
    return "\n".join(rows)


if __name__ == "__main__":
    import sys
    print(table(sys.argv[1] if len(sys.argv) > 1 else "single"))
