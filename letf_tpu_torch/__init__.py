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
``device``. Kernels and their plain versions compute in float32; the glue
(regime spells, start conditions) and the tax bridge run in float64 on the
CPU, mirroring the JAX test suite's x64 mode, and in float32 on the card,
mirroring JAX's default mode. Nothing falls back to the CPU on its own.

The package imports torch and never jax; it shares only the NumPy-only
modules ``letf_tpu.config``, ``letf_tpu.models.params``,
``letf_tpu.reporting`` (tax configuration), ``letf_tpu.income`` and
``letf_tpu.tax.engine`` / ``letf_tpu.tax.brackets`` (the statute) with
the reference.
"""

__version__ = "0.2.0"
