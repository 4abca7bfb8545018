"""Checkpoints of a calibrated model and the manifest of a resumable run.

Port of ``letf_tpu/utils/checkpoint.py`` in its ``.npz`` format (the JAX
package's fallback when orbax is absent, which the JAX package also reads
when no orbax checkpoint exists at the path): ``np.savez(path + ".npz")``
with one ``group.field`` key a leaf of the ``SimModel`` tree. The run
manifest is the JSON file that ``run_monte_carlo(checkpoint_dir=...)``
writes beside its chunk files; a killed run resumes from it bit for bit,
since every trial replays from (seed, trial id).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from letf_tpu_torch.models.params import SimModel


def save_sim_model(model: SimModel, path: str | Path) -> None:
    """Write ``model`` to ``path + ".npz"``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(str(path) + ".npz", **dict(flat_model_arrays(model)))


def load_sim_model(path: str | Path,
                   template: Optional[SimModel] = None) -> Optional[SimModel]:
    """The model saved at ``path`` (``path + ".npz"``), or None when there
    is none. Fields the file lacks (an older format) take the template's
    value (by default the reference defaults')."""
    from letf_tpu_torch.models.params import default_sim_model

    npz = Path(str(path) + ".npz")
    if not npz.exists():
        return None
    with np.load(npz) as f:
        flat = dict(f)
    return unflatten_model(template if template is not None
                           else default_sim_model(), flat)


def flat_model_arrays(model: SimModel):
    """The nested NamedTuple as ('group.field', array) pairs."""
    for group_name, group in model._asdict().items():
        if hasattr(group, "_asdict"):
            for field, arr in group._asdict().items():
                yield f"{group_name}.{field}", np.asarray(arr)
        else:
            yield group_name, np.asarray(group)


def unflatten_model(template: SimModel, flat) -> SimModel:
    groups = {}
    for group_name, group in template._asdict().items():
        if hasattr(group, "_asdict"):
            fields = {f: np.asarray(flat.get(f"{group_name}.{f}",
                                             getattr(group, f)))
                      for f in group._fields}
            groups[group_name] = type(group)(**fields)
        else:
            groups[group_name] = np.asarray(flat[group_name])
    return SimModel(**groups)


def save_run_manifest(path: str | Path, *, seed: int, num_simulations: int,
                      time_horizon: float, completed_trials: int,
                      engine_mode: str, **extra) -> None:
    """The JSON manifest of a resumable run: the remaining trials
    regenerate exactly from (seed, trial id). ``extra``: the further
    configuration fields the resume check compares."""
    Path(path).write_text(json.dumps({
        "seed": seed, "num_simulations": num_simulations,
        "time_horizon": time_horizon, "completed_trials": completed_trials,
        "engine_mode": engine_mode, **extra,
    }, indent=2))


def load_run_manifest(path: str | Path):
    p = Path(path)
    return json.loads(p.read_text()) if p.exists() else None
