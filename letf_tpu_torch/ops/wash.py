"""Wash-sale replacement matching (kernel K8).

Port of ``letf_tpu/ops/pallas_wash.py::wash_matching_pallas`` and of the
scan it replaces, ``letf_tpu/tax/device_bridge.py::_wash_matching_scan``
(reference semantics: wash_sale.py:256-320). For each day with a loss sale,
the nearest unused buy within +-30 days (nearer first, earlier first at
equal distance) becomes the replacement and is used up; the disallowed loss
is loss * min(1, replacement shares / sold shares).

Layout ``[S, B]`` (days first, trials contiguous). ``wash_matching``
launches ``csrc/wash.cu`` on CUDA tensors (day bitsets, a per-trial walk
over the loss days, a coalesced epilogue; float64 inputs, as the bridge
computes) and runs ``wash_plain`` on CPU ones (any float dtype);
both return (disallowed [S, B], rep_off [S, B] int32 in [-30, 30], has
[S, B] bool), bitwise equal.
"""

from __future__ import annotations

import torch

from letf_tpu_torch.ops import _build

LAUNCHES = 0            # kernel launches by wash_matching on CUDA tensors
WINDOW = 30
MIN_SHARES = 0.001


def wash_plain(loss, sell_sh, buy_q):
    """Plain PyTorch K8: the reference scan's day loop over a sliding
    61-day window of used-buy flags."""
    S, B = loss.shape
    dev = loss.device
    W = 2 * WINDOW + 1
    qpad = torch.nn.functional.pad(buy_q, (0, 0, WINDOW, WINDOW))  # [S+60, B]
    offs = torch.arange(-WINDOW, WINDOW + 1, device=dev)             # [61]
    pref = (offs.abs() * 4 + (offs > 0).to(offs.dtype))[:, None]     # [61, 1]
    nonzero = (offs != 0)[:, None]
    used = torch.zeros((W, B), dtype=torch.bool, device=dev)
    dis = torch.empty_like(loss)
    rep_off = torch.empty((S, B), dtype=torch.int32, device=dev)
    has = torch.empty((S, B), dtype=torch.bool, device=dev)
    for d in range(S):
        win_q = qpad[d:d + W]                                         # [61, B]
        in_bounds = ((offs + d >= 0) & (offs + d < S))[:, None]
        eligible = (win_q > MIN_SHARES) & ~used & nonzero & in_bounds
        key = torch.where(eligible, pref, 10_000)
        best = torch.argmin(key, dim=0)                               # [B]
        sel = torch.arange(W, device=dev)[:, None] == best[None, :]
        h = (loss[d] > 0) & torch.gather(eligible, 0, best[None])[0]
        rep_q = torch.gather(win_q, 0, best[None])[0]
        m_d = sell_sh[d]
        frac = torch.where(rep_q >= m_d, 1.0,
                           rep_q / torch.clamp_min(m_d, 1e-30))
        dis[d] = torch.where(h, loss[d] * frac, 0.0)
        rep_off[d] = torch.where(h, best - WINDOW, 0).to(torch.int32)
        has[d] = h
        used = torch.cat([(used | (sel & h[None]))[1:],
                          torch.zeros((1, B), dtype=torch.bool, device=dev)])
    return dis, rep_off, has


MAX_SMEM = 227 * 1024     # dynamic shared bytes a block can take


def match_smem(S: int) -> int:
    """Dynamic shared bytes of the loss-day walk at S days, as
    csrc/wash.cu's match_smem(ceil(S / 32)): the loss and eligible-buy
    words of a warp's 32 trials, one extra word each."""
    return (2 * -(-S // 32) + 2) * 32 * 4


def check_smem(S: int) -> int:
    """``match_smem(S)``, or a ValueError where the card cannot give it
    (past about 29,000 days)."""
    smem = match_smem(S)
    if smem > MAX_SMEM:
        raise ValueError(f"wash_matching: {S} days need {smem} bytes of "
                         f"shared memory; the kernel takes at most "
                         f"{MAX_SMEM}")
    return smem


def wash_matching(loss, sell_sh, buy_q):
    """K8 on the device of the inputs: the CUDA kernel for float64 CUDA
    tensors, ``wash_plain`` for CPU tensors."""
    global LAUNCHES
    if loss.device.type == "cpu":
        return wash_plain(loss, sell_sh, buy_q)
    S, B = loss.shape
    if sell_sh.shape != (S, B) or buy_q.shape != (S, B):
        raise ValueError("wash_matching: loss, sell_sh, buy_q must be [S, B]")
    check_smem(S)
    dev = loss.device
    _build.check_cuda("wash_matching", dev, loss=(loss, torch.float64),
                      sell_sh=(sell_sh, torch.float64),
                      buy_q=(buy_q, torch.float64))
    dis = torch.empty_like(loss)
    rep_off = torch.empty((S, B), dtype=torch.int32, device=dev)
    has = torch.empty((S, B), dtype=torch.uint8, device=dev)
    # The eligible-buy and loss-day bitsets, [2, ceil(S / 32), B] words.
    bits = torch.empty((2, -(-S // 32), B), dtype=torch.int32, device=dev)
    rc = _build.library().letf_wash(
        loss.data_ptr(), sell_sh.data_ptr(), buy_q.data_ptr(), S, B,
        dis.data_ptr(), rep_off.data_ptr(), has.data_ptr(), bits.data_ptr(),
        _build.stream_of(loss))
    _build.check(rc, "letf_wash")
    LAUNCHES += 1
    return dis, rep_off, has.view(torch.bool)
