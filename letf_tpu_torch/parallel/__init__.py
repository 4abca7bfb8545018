"""Parallel execution: the trial mesh and the chunked Monte Carlo runner.

A mesh (``mesh.trial_mesh``) splits each chunk's trials over its shards'
devices from one process; the only cross-device traffic is the gather of
each chunk's summaries.
"""

from letf_tpu_torch.parallel.mesh import TrialMesh, trial_mesh
from letf_tpu_torch.parallel.mc_runner import (
    MCArrays,
    monte_carlo_report,
    parallel_monte_carlo_fixed,
    run_monte_carlo,
)

__all__ = ["MCArrays", "TrialMesh", "monte_carlo_report",
           "parallel_monte_carlo_fixed", "run_monte_carlo", "trial_mesh"]
