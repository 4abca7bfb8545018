"""One production chunk: model tables to strategy summaries.

Port of ``letf_tpu/ops/slab_chunk.py::slab_chunk_summaries``. The chain:

  start conditions + regime spells, K1 joint generation (csrc/joint.cu),
  moment matching and the K2 random-start window (csrc/window.cu) --
  ops/path_batched.windowed_chain, shared with the general path
  -> K3 compose + signals + 19 strategies
                                    (ops/compose_strategies.py,
                                     csrc/compose_strategies.cu)

Every per-day tensor is ``[T, B]`` (trials contiguous). The JAX version
sorted trial lanes by offset for the TPU shift-select tree; per-trial
results do not depend on lane order, so the port keeps trial order.
Returns the 13-key summary dict of ``_mc_chunk_body``.
"""

from __future__ import annotations

from letf_tpu_torch.models import params as tparams
from letf_tpu_torch.ops import path_batched as pb
from letf_tpu_torch.ops.compose_strategies import compose_strategies


def slab_chunk_summaries(model, run_key, trial_ids, antithetic,
                         sim_days: int, buffer_days: int = 0,
                         random_start_method: str = "offset",
                         anchors=None, cashflows=None,
                         apply_costs: bool = True,
                         moment_matching: bool = True,
                         max_spells: int | None = None):
    """One chunk on the device of ``trial_ids``. ``model``: the port's
    torch SimModel (models/params.from_numpy) on that device, in the glue
    dtype; ``run_key``: a threefry key (ops/rng.key); ``trial_ids`` [B]
    base ids (antithetic pairs share one); ``antithetic`` [B] bool."""
    sc, ids32, seed_words, chans = pb.windowed_chain(
        model, run_key, trial_ids, antithetic, sim_days, buffer_days,
        random_start_method, anchors, moment_matching, max_spells)

    (fw, nt, mdd, path_finite, jc, ls, cs, vix_min, vix_max,
     regime_high) = compose_strategies(
        tparams.pack_stress_params(model), tparams.pack_asset_params(model),
        ids32, seed_words, *chans, cashflows=cashflows,
        apply_costs=apply_costs)
    del chans

    # Validity flags (slab_chunk.py:142-153): a NaN VIX poisons the running
    # min/max (compares false), +-inf fails the bounds.
    vix_ok = (vix_min >= 5.0) & (vix_max <= 120.0)
    repaired = ~(path_finite & vix_ok)
    return dict(
        final_wealth=fw, num_trades=nt, max_dd=mdd,
        valid=vix_ok, repaired=repaired,
        path_finite=path_finite, vix_ok=vix_ok,
        start_offset=sc.start_offset, start_regime=sc.start_regime,
        jump_days=jc, liq_mean=ls / sim_days, credit_mean=cs / sim_days,
        regime_high_days=regime_high)
