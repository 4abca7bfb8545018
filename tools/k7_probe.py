#!/usr/bin/env python3
"""Times kernel K7, the tax bridge's merge (``letf_tpu_torch/ops/
sort_bridge.py``, ``csrc/merge.cu``), of this tree or of another one, beside
``torch.sort`` of the same columns, on one NVIDIA GPU.

    python3 tools/k7_probe.py [--root DIR] [--reps 5]

``--root``: a checkout (for example an older commit's ``git archive``
unpacked under ``build/``) whose ``letf_tpu_torch`` is imported and built
instead of this tree's. To compare two versions, run the probe for each in
one machine session, in turns (old, new, new, old).

Cases: merge with 2 payloads and valley with 4 payloads and
``head_payloads_zero`` at [2S, R] = [15,120, 600] (the sampled report's
bridge batch) and [15,120, 8,192] (the exact-tax report's fold), and merge
with 2 payloads at the 50-year [25,200, 256]. Bridge-like operands: non-
negative float32 keys with ties (each half ascending, the valley's first
half unsorted), the unique packed secondary (tag << 24) | position.

Prints one JSON line: the root, the card, and per case the min / median /
max milliseconds of ``sort_bridge`` over ``--reps`` runs (CUDA events,
after a warm-up), whether it is bitwise ``sort_bridge_plain``, the median
of one stable ``torch.sort`` of the packed int64 (key, sec) columns, and
the bytes bound (each input read once, each output written once, at
3.35 TB/s); then the merge kernel's ``kernel_info``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

PEAK_BYTES = 3.35e12
CASES = (("merge", 2, 7560, 600), ("valley", 4, 7560, 600),
         ("merge", 2, 7560, 8192), ("valley", 4, 7560, 8192),
         ("merge", 2, 12600, 256))


def operands(g, kind, n_pay, S, R):
    N = 2 * S
    key = torch.round(torch.randn((N, R), generator=g, device="cuda").abs()
                      * 4) / 4
    key[S:] = torch.sort(key[S:], dim=0).values
    if kind == "merge":
        key[:S] = torch.sort(key[:S], dim=0).values
    pos = torch.arange(N, device="cuda", dtype=torch.int32)
    sec = torch.where(pos >= S, pos | (1 << 24), pos)[:, None].expand(
        N, R).contiguous()
    pays = [torch.randn((N, R), generator=g, device="cuda")
            for _ in range(n_pay)]
    if kind == "valley":
        for p in pays:
            p[:S] = 0.0
    return key, sec, tuple(pays)


def spread(fn, reps):
    fn()
    ms = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return [min(ms), float(np.median(ms)), max(ms)], out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from letf_tpu_torch.ops import _build
    from letf_tpu_torch.ops import sort_bridge as k7
    assert Path(k7.__file__).resolve().is_relative_to(root), k7.__file__

    _build.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(8)
    cases = []
    for kind, n_pay, S, R in CASES:
        key, sec, pays = operands(g, kind, n_pay, S, R)
        hz = kind == "valley"
        ms, got = spread(lambda: k7.sort_bridge(key, sec, pays, kind=kind,
                                                head_payloads_zero=hz),
                         args.reps)
        ref = k7.sort_bridge_plain(key, sec, pays)
        bitwise = all(torch.equal(a, b) for a, b in zip(got, ref))
        del got, ref
        ok = k7._order_key(key, sec)
        lib, _ = spread(lambda: torch.sort(ok, dim=0, stable=True), 3)
        del ok
        words = 2 * (2 * S) + (n_pay * S if hz else n_pay * 2 * S) \
            + (2 + n_pay) * 2 * S
        cases.append(dict(kind=kind, payloads=n_pay, shape=[2 * S, R],
                          ms=ms, bitwise=bitwise, torch_sort_ms=lib[1],
                          bound_ms=words * R * 4 / PEAK_BYTES * 1e3))
        del key, sec, pays
        torch.cuda.empty_cache()
    info = _build.kernel_info().get("merge")
    print(json.dumps(dict(root=str(root), card=smi, cases=cases,
                          kernel_info_merge=info)), flush=True)


if __name__ == "__main__":
    main()
