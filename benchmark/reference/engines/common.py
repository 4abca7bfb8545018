"""What the plain engines share: the run's trial layout and the model."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import config as cfg


def layout(rows, antithetic: bool):
    """Base trial ids and antithetic flags of report rows: row r is trial
    r // 2, antithetic when r is odd (pairs share a base id)."""
    rows = np.asarray(rows, np.int64)
    if antithetic:
        return rows // 2, (rows % 2) == 1
    return rows, np.zeros(rows.shape, bool)


def model(config: dict):
    """The configuration's model tables as the reference builds them
    (``benchmark/models/<model>.py``'s ``reference()``)."""
    from benchmark.harness import spec

    return spec.model(config["model"]).reference()


def days(config: dict, horizon_years: float):
    """(simulated days, random-start buffer days) of a report."""
    sim = int(horizon_years * cfg.TRADING_DAYS)
    buf = (int(config["random_start_buffer_years"] * cfg.TRADING_DAYS)
           if config["random_start_method"] == "offset" else 0)
    return sim, buf


def host_one(x) -> np.ndarray:
    """A result as a host array (floats as float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype.is_floating_point else x).numpy()
    return np.asarray(x)


def tensors(ids, anti, device):
    return (torch.as_tensor(ids, dtype=torch.int64, device=device),
            torch.as_tensor(anti, dtype=torch.bool, device=device))
