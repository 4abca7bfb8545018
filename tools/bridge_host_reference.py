#!/usr/bin/env python3
"""The exact-all bridge against the host tax chain over 30-year trade lists.

    JAX_PLATFORMS=cpu python3 -m tools.bridge_host_reference \
        [--trials N | --rows R [R ...]]

On the CPU in float64: the port's general path replays the first N
trials (default 128), or the rows R, of the committed fits' 4,096-trial
results list (seed 0, 30 years, as ``chip_smoke.py``'s
``analysis_replay`` runs it on the card, which logs each strategy's
worst row) with journal emission. For S7, S10 and S12 it prints each
trial set's largest difference between the port's device bridge plus the
vectorized tax (``reporting.bridge_tax`` in float64) and the port's host
tax chain (``integration.process_trades_with_wired_engine`` on the trade
lists of the same emission), in dollars and relative to the larger of
the tax and the trial's gross traded dollars (the smoke's
``REPLAY_TAX_BOUNDS`` scale). For the worst trial it also prints the JAX
package's bridge (``letf_tpu/tax/device_bridge.py``, on the same emission
cast to float64 with x64 on; the dtype it computed in is printed) and
host chain on the same trades, the two bridges' difference, and the
largest yearly-activity difference between the port's bridge and its
host-side vectorized activity
(``tax/vectorized.yearly_activity_from_trades``). Two minutes or so.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from letf_tpu_torch import config as tcfg  # noqa: E402
from letf_tpu_torch import reporting  # noqa: E402
from letf_tpu_torch.integration import (  # noqa: E402
    process_trades_with_wired_engine,
)
from letf_tpu_torch.parallel import mc_runner  # noqa: E402
from letf_tpu_torch.strategies.host import trades_from_emission  # noqa: E402
from letf_tpu_torch.tax import device_bridge  # noqa: E402
from letf_tpu_torch.tax.engine import TaxpayerElections  # noqa: E402
from letf_tpu_torch.tax.vectorized import (  # noqa: E402
    yearly_activity_from_trades,
)

YEARS, N_RESULTS, SIDS = 30, 4096, ("S7", "S10", "S12")


def host_tax(trades, sid, integration=process_trades_with_wired_engine,
             elections=TaxpayerElections, capital=tcfg.INITIAL_CAPITAL):
    if not trades:
        return 0.0
    with contextlib.redirect_stdout(io.StringIO()):
        return integration(trades=trades, time_horizon_years=YEARS,
                           elections=elections(), initial_capital=capital,
                           strategy_id=f"{sid}_bulk",
                           tax_config=None)["total_tax"]


def jax_side(stacked, trades, sid):
    """The JAX package's bridge tax and host-chain tax of one trial."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from letf_tpu import config as jcfg
    from letf_tpu import integration as jint
    from letf_tpu import reporting as jrep
    from letf_tpu.income import simulate_wired_income_path
    from letf_tpu.tax import device_bridge as jbridge
    from letf_tpu.tax import vectorized as jvec
    from letf_tpu.tax.engine import TaxpayerElections as JElections

    act, ntr, _ = jbridge.yearly_activity_from_emission(
        *[jnp.asarray(a[:, None].astype(np.float64)
                      if a.dtype.kind == "f" else a[:, None])
          for a in stacked], n_years=YEARS, assets=(0,))
    income = simulate_wired_income_path(
        150000, YEARS, **jrep._income_kwargs(jrep.DEFAULT_TAX_CONFIG))
    tax = jvec.total_tax_all_trials(
        act[..., :4], jnp.asarray(income), jcfg.INITIAL_CAPITAL,
        ntr.astype(act.dtype) / YEARS, filing_status="single",
        state_code="CA")["total_tax"]
    return (float(tax[0]), str(act.dtype),
            host_tax(trades, sid, jint.process_trades_with_wired_engine,
                     JElections, jcfg.INITIAL_CAPITAL))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=128)
    ap.add_argument("--rows", type=int, nargs="+")
    a = ap.parse_args()
    rows = np.asarray(a.rows) if a.rows else np.arange(a.trials)
    n = len(rows)
    torch.set_num_threads(4)
    model, _ = chip_smoke.committed_fits()
    run = mc_runner._Run(model, YEARS, N_RESULTS, 0, None, device="cpu")
    ids, anti = mc_runner._trial_layout(N_RESULTS, run.use_antithetic)
    _, em = mc_runner.general_chunk(run, ids[rows], anti[rows],
                                    apply_costs=True)
    income, tax_kw = reporting.tax_setup(None, YEARS)
    out = {}
    for sid in SIDS:
        c = tcfg.TAXABLE_IDS.index(sid)
        stacked = reporting.bridge_columns(e[:, :, c].contiguous()
                                           for e in em)
        bridge = reporting.bridge_tax(stacked, (0,), YEARS, income,
                                      tax_kw).numpy()
        tj = [e[:, :, c:c + 1].numpy() for e in em]
        lists = [trades_from_emission(*tj, b, 0) for b in range(n)]
        host = np.array([host_tax(t, sid) for t in lists])
        gross = np.array([sum(t["dollar_amount"] for t in tr)
                          for tr in lists])
        diff = np.abs(bridge - host)
        rel = (np.maximum(diff - 1.0, 0.0)
               / np.maximum(np.maximum(np.abs(host), gross), 1.0))
        w = int(rel.argmax())
        entry = dict(max_abs=float(diff.max()),
                     max_rel_scale=float(rel.max()), worst_row=int(rows[w]),
                     port_bridge=float(bridge[w]), port_host=float(host[w]),
                     trades=len(lists[w]))
        if rel.max() > 0:
            one = [s[:, w].numpy() for s in stacked]
            act, _, _ = device_bridge.yearly_activity_from_emission(
                *[torch.as_tensor(a[:, None]) for a in one], n_years=YEARS,
                assets=(0,))
            vec = yearly_activity_from_trades(lists[w], YEARS,
                                              TaxpayerElections())
            entry["activity_vs_host_vectorized"] = float(
                np.abs(act.numpy()[0, :, :4] - vec[:, :4]).max())
            (entry["jax_bridge"], entry["jax_bridge_dtype"],
             entry["jax_host"]) = jax_side(one, lists[w], sid)
            entry["port_bridge_minus_jax_bridge"] = (entry["port_bridge"]
                                                     - entry["jax_bridge"])
        out[sid] = entry
        print(sid, json.dumps(entry), flush=True)


if __name__ == "__main__":
    main()
