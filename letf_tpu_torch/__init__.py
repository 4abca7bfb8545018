"""letf_tpu_torch: the PyTorch/CUDA port of letf_tpu for one NVIDIA H100.

The JAX package ``letf_tpu`` stays the reference. This package runs the
production percentile report (``parallel.mc_runner.monte_carlo_report``):
the pre-tax fans and, by default (``tax_mode="sampled"``), the sampled
post-tax tables, whose replay runs the trade-emitting general path and the
FIFO tax bridge; ``emit_trade_lists`` is that path's own entry point. The
six Pallas kernels of these paths are hand-written CUDA C++ kernels for
sm_90a (``csrc/``), each beside a plain PyTorch version of the same
function.

Device policy (``utils.device``): every public entry takes an explicit
``device``. The path kernels and their plain versions compute in
float32; the glue (regime spells, start conditions) runs in float64 on
the CPU, mirroring the JAX test suite's x64 mode, and in float32 on the
card, mirroring JAX's default mode; every tax bridge (K7, K8) runs in
float64 on both (``reporting.BRIDGE_DTYPE``). Nothing falls back to the
CPU on its own.

The production entry runs from the data to the fans
(``runner.run_report``, ``python -m letf_tpu_torch.cli --report``): the
offline market history (``data.py`` on ``utils/frame.py``, a pandas-free
day frame), the calibration of every model (``calibration.py``, its fits
in float64 on the device, ``ops/fitting.py``), the golden tax gate
(``tax/engine.py``) and one report per horizon.

The reference's complete analysis runs too (``runner.run``, the CLI's
default branch, ``--quick``): the validation battery, per horizon the
reference-format results list (``parallel.mc_runner.parallel_monte_carlo_fixed``),
the Roth and taxable tables through the host tax chain
(``reporting.create_summary_statistics``, ``integration.py``, ``tax/``)
and the comparison with history (``historical.py``).

The reference's oracles run on the host in float64: the path oracle
(``oracle.py``) and the host strategy oracle (``strategies/host.py``,
behind ``historical.run_strategy_on_history``); ``tqqq.py`` is the root
TQQQ sanity flow.

The package imports torch, numpy and scipy, and never jax, the JAX
package or pandas: it keeps its own copies of the configuration, the
model tree, the tax statute and the income path.
"""

__version__ = "0.2.0"
