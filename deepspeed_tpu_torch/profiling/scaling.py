"""Scaling arithmetic: a measured step breakdown and a many-card projection.

Counterpart of ``deepspeed_tpu/profiling/scaling.py``, the same arithmetic
with the same keys, so a port run's numbers and the JAX package's go
through one formula.

Breakdown: a step of ``g`` gradient-accumulation microbatches costs
``t(g) = g * t_micro + t_update`` (the microbatches scale with g; the
optimizer update, and any offload streaming, is paid once a step). Two
measured step times solve both unknowns.

Projection (ZeRO-3 over ``n_chips`` data-parallel cards, bf16, Megatron
accounting): a step all-gathers the sharded params for the forward (about
2n·(N−1)/N bytes), again for the recomputed backward (2n), and
reduce-scatters the gradients (2n): about 6n bytes a card a step over the
links. How much of it hides under compute is not known, so the projection
gives the no-overlap and full-overlap bounds and a middle estimate.
"""

from __future__ import annotations

from typing import Dict

# Bytes/s a card moves to its peers in a ring collective: NVLink 4's
# published 900 GB/s per H100 is both directions together, 450 GB/s each
# way. A knob for the projection, not a measurement: pass the rate a
# collective benchmark (comm/benchmark.py) measured where there is one.
NVLINK_BYTES_PER_S = 450e9


def solve_breakdown(t_a: float, g_a: int, t_b: float, g_b: int) -> Dict[str, float]:
    """Solve ``t(g) = g*t_micro + t_update`` from step times ``t_a`` at
    ``g_a`` microbatches and ``t_b`` at ``g_b``.

    A non-physical solution (``t_micro <= 0``, or ``t_update`` below −5% of
    ``t_a``) raises instead of being clamped: it means the measurement was
    disturbed, and a clamped update time would read as a rosy breakdown. A
    small negative ``t_update`` is noise and becomes 0."""
    t_micro = (t_b - t_a) / (g_b - g_a)
    t_update = t_a - g_a * t_micro
    if t_micro <= 0.0 or t_update < -0.05 * t_a:
        raise ValueError(
            f"non-physical breakdown: t({g_a})={t_a:.4f}s t({g_b})={t_b:.4f}s "
            f"-> t_micro={t_micro:.4f}s t_update={t_update:.4f}s "
            "(measurement disturbed — retry)")
    t_update = max(0.0, t_update)
    return {"t_micro_s": t_micro, "t_update_s": t_update,
            "update_fraction": t_update / max(t_a, 1e-12)}


def project_northstar(n_params: int,
                      tokens_per_chip_step: int,
                      flops_per_token: float,
                      measured_mfu_1chip: float,
                      peak_flops: float,
                      n_chips: int = 64,
                      ici_bytes_per_s: float = NVLINK_BYTES_PER_S,
                      overlap_mid: float = 0.7,
                      t_update_shard_s: float = 0.0) -> Dict:
    """First-order MFU of ZeRO-3 over ``n_chips`` data-parallel cards.

    ``measured_mfu_1chip``: the measured one-card MFU of the same model
    without offload (sharded n ways, each card holds 12n/N bytes of fp32
    state, so no host streaming remains); outside (0, 1) it raises rather
    than being clamped. ``ici_bytes_per_s``: each card's collective
    bytes/s to its peers (the name is the JAX package's; here it is the
    NVLink rate). ``t_update_shard_s``: the measured optimizer update of
    one card's 1/N shard, serial with compute (it waits for the last
    gradient), so it is added to the step whatever the overlap."""
    if not (0.0 < measured_mfu_1chip < 1.0):
        raise ValueError(f"measured_mfu_1chip={measured_mfu_1chip} out of "
                         "(0, 1) — measurement disturbed; re-measure instead "
                         "of clamping")
    compute_s = (tokens_per_chip_step * flops_per_token
                 / (peak_flops * measured_mfu_1chip))
    frac = (n_chips - 1) / n_chips
    comm_bytes = 6 * n_params * frac          # 2 all-gathers + 1 reduce-scatter, bf16
    comm_s = comm_bytes / ici_bytes_per_s

    def mfu(overlap):
        exposed = (1.0 - overlap) * comm_s
        return (measured_mfu_1chip * compute_s
                / (compute_s + exposed + t_update_shard_s))

    return {
        "n_chips": n_chips,
        "assumed_ici_bytes_per_s": ici_bytes_per_s,
        "per_chip_step_compute_s": round(compute_s, 4),
        "per_chip_step_comm_s": round(comm_s, 4),
        "per_chip_step_update_s": round(t_update_shard_s, 4),
        "comm_bytes_per_chip_step": int(comm_bytes),
        "projected_mfu_no_overlap": round(mfu(0.0), 4),
        "projected_mfu_mid_overlap": round(mfu(overlap_mid), 4),
        "projected_mfu_full_overlap": round(mfu(1.0), 4),
        "assumptions": "ZeRO-3 dp sharding; 2 param all-gathers + 1 grad "
                       "reduce-scatter per step (bf16); fp32 state + sharded "
                       "Adam update dp-sharded in HBM (no host offload at 64 "
                       f"chips); overlap_mid={overlap_mid}",
    }
