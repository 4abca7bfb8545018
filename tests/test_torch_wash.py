"""Kernel K8 (wash-sale replacement matching) of the port: its plain
PyTorch version bitwise against ``wash_matching_pallas`` in interpret mode
and against the reference scan ``_wash_matching_scan``; a numpy model of
the CUDA kernel's bitset matching bitwise against both.

Inputs as tests/test_device_bridge.py:115 makes them: sparse buys, sells
and losses on half the sells, so losses without an eligible replacement,
used-buy exclusion, window-edge days and partial fractions all occur. The
port's layout is [S, B] (days first)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from letf_tpu.ops.pallas_wash import wash_matching_pallas
from letf_tpu.tax.device_bridge import _wash_matching_scan
from letf_tpu_torch.ops.wash import wash_matching
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, S = 1024, 300


def _inputs(dtype):
    rng = np.random.default_rng(11)
    buy = np.where(rng.random((B, S)) < 0.25, rng.gamma(2.0, 3.0, (B, S)),
                   0.0)
    sell = np.where(rng.random((B, S)) < 0.15, rng.gamma(2.0, 4.0, (B, S)),
                    0.0)
    loss = np.where(rng.random((B, S)) < 0.5, rng.gamma(2.0, 50.0, (B, S)),
                    0.0)
    loss = np.where(sell > 0, loss, 0.0)
    return [a.astype(dtype) for a in (loss, sell, buy)]


def _port(arrays):
    return wash_matching(*[torch.as_tensor(a.T.copy()) for a in arrays])


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().T, np.asarray(w))


@pytest.fixture(scope="module")
def f32():
    arrays = _inputs(np.float32)
    return arrays, _port(arrays)


def test_wash_plain_matches_pallas_bitwise(f32):
    arrays, got = f32
    _equal(got, wash_matching_pallas(*[jnp.asarray(a) for a in arrays],
                                     interpret=True))
    assert got[2].sum() > 1000 and (got[1].abs() == 30).any()


def test_wash_plain_matches_scan_bitwise(f32):
    arrays, got = f32
    _equal(got, _wash_matching_scan(*[jnp.asarray(a) for a in arrays]))


def test_wash_plain_matches_scan_float64():
    arrays = _inputs(np.float64)
    _equal(_port(arrays),
           _wash_matching_scan(*[jnp.asarray(a) for a in arrays]))


# ---- A numpy transcription of the kernel's bitset matching (csrc/wash.cu):
# (a) eligible-buy and loss-day words, (b) per trial, each loss day's window
# from three words by funnel shifts, the highest available bit below the
# day against the lowest above it, the used buy's bit cleared in an
# absolute-day bitset, (c) the epilogue. The CUDA kernel cannot run here;
# this model is held bitwise to the plain version and to the Pallas kernel
# (whose used flags are a 64-row ring) on edge cases and hypothesis-made
# ones.

def _funnel_r(lo, hi, s):
    return ((hi << 32 | lo) >> s) & 0xFFFFFFFF


def _words(mask):
    """[S, B] bool -> [ceil(S / 32), B] Python-int words, bit j of word k
    = day 32 k + j, days past S zero."""
    S, B = mask.shape
    nw = -(-S // 32)
    pad = np.zeros((nw * 32, B), bool)
    pad[:S] = mask
    w = (pad.reshape(nw, 32, B).astype(np.uint64)
         << np.arange(32, dtype=np.uint64)[None, :, None]).sum(1)
    return [[int(x) for x in row] for row in w]


def wash_bitset_model(loss, sell, buy):
    """(dis, rep_off, has) as csrc/wash.cu computes them, [S, B] numpy."""
    S, B = loss.shape
    ebits = _words(buy > np.asarray(0.001, buy.dtype))
    lbits = _words(loss > 0)
    nw = len(ebits)
    off = np.zeros((S, B), np.int32)
    for b in range(B):
        avail = [0] + [ebits[k][b] for k in range(nw)] + [0]
        for k in range(nw):
            pending = lbits[k][b]
            while pending:
                d = 32 * k + (pending & -pending).bit_length() - 1
                pending &= pending - 1
                s = d & 31
                lo = _funnel_r(avail[k], avail[k + 1], s) & 0xFFFFFFFC
                hi = (_funnel_r(avail[k + 1], avail[k + 2], s) >> 1) \
                    & 0x3FFFFFFF
                below = (32 - lo.bit_length()) + 1 if lo else 99
                above = (hi & -hi).bit_length()
                o = 0
                if below <= 30 and (above == 0 or below <= above):
                    o = -below
                elif above:
                    o = above
                if o:
                    x = d + o
                    avail[(x >> 5) + 1] &= ~(1 << (x & 31))
                off[d, b] = o
    has = (loss > 0) & (off != 0)
    rows = np.arange(S)[:, None] + off
    q = np.take_along_axis(buy, rows, 0)
    one = np.asarray(1.0, loss.dtype)
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(q >= sell, one,
                        q / np.maximum(sell, np.asarray(1e-30, loss.dtype)))
        dis = np.where(has, loss * frac, np.asarray(0.0, loss.dtype))
    return dis, np.where(has, off, 0).astype(np.int32), has


_PALLAS_S = (1, 45, 97, 150)    # day counts the Pallas kernel compiles for


def _check_model(loss, sell, buy):
    """The model bitwise against wash_plain and wash_matching_pallas
    (interpret mode; trials padded to its 1,024-trial tile)."""
    S, B = loss.shape
    assert S in _PALLAS_S
    got = wash_bitset_model(loss, sell, buy)
    plain = wash_matching(*[torch.as_tensor(a) for a in (loss, sell, buy)])
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p.numpy())
    pad = [np.zeros((1024, S), np.float32) for _ in range(3)]
    for p, a in zip(pad, (loss, sell, buy)):
        p[:B] = a.T
    ref = wash_matching_pallas(*[jnp.asarray(p) for p in pad],
                               interpret=True)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r)[:B].T)
    return got


def _case(S, B, seed, p_buy=0.25, p_loss=0.1):
    rs = np.random.default_rng(seed)
    buy = np.where(rs.random((S, B)) < p_buy, rs.gamma(2.0, 3.0, (S, B)), 0.0)
    sell = rs.gamma(2.0, 4.0, (S, B))
    loss = np.where(rs.random((S, B)) < p_loss, rs.gamma(2.0, 50.0, (S, B)),
                    0.0)
    return [a.astype(np.float32) for a in (loss, sell, buy)]


def _every_day_a_loss():
    loss, sell, buy = _case(150, 9, 1, p_loss=1.0)
    return loss, sell, buy


def _buys_every_day():
    loss, sell, buy = _case(97, 9, 2, p_buy=1.0, p_loss=0.4)
    return loss, sell, buy


def _buys_at_threshold():
    loss, sell, buy = _case(97, 9, 3, p_buy=0.0, p_loss=0.3)
    rs = np.random.default_rng(30)
    at = np.float32(0.001)
    pick = rs.integers(0, 3, buy.shape)
    buy[:] = np.where(pick == 0, at, np.where(pick == 1,
                                              np.nextafter(at, np.inf), 0.0))
    return loss, sell, buy


def _first_and_last_day_losses():
    S = 97
    loss, sell, buy = _case(S, 6, 4, p_loss=0.0)
    loss[[0, S - 1]] = 50.0
    buy[:] = 0.0
    buy[[1, 30, 31, S - 2, S - 31, S - 32], :3] = 2.0   # within and past
    buy[[30, S - 31], 3:] = 5.0                          # at the window edge
    return loss, sell, buy


def _equal_distance_ties():
    S = 97
    loss, sell, buy = _case(S, 6, 5, p_loss=0.0)
    buy[:] = 0.0
    for b, (d, k) in enumerate(((40, 1), (40, 30), (31, 31), (50, 7),
                                (64, 3), (63, 17))):
        loss[d, b] = 10.0
        buy[[d - k, d + k], b] = (1.0, 100.0)
        loss[d + 1, b] = 20.0           # takes the other side next
    return loss, sell, buy


def _ring_reuse():
    """A buy used on day x; the buy of day x + 64, the reference's ring
    slot of day x, must still be found 30 days ahead of day x + 34."""
    S = 150
    loss, sell, buy = _case(S, 4, 6, p_loss=0.0)
    buy[:] = 0.0
    for b, x in enumerate((2, 33, 40, 60)):
        buy[[x, x + 64], b] = 3.0
        loss[[x + 1, x + 34], b] = 7.0
    return loss, sell, buy


WASH_CASES = {
    "one_day": lambda: _case(1, 8, 7, p_loss=0.5),
    "shorter_than_the_window": lambda: _case(45, 33, 8),
    "ragged_days": lambda: _case(97, 33, 9),
    "every_day_a_loss": _every_day_a_loss,
    "buys_every_day": _buys_every_day,
    "buys_at_the_threshold": _buys_at_threshold,
    "first_and_last_day_losses": _first_and_last_day_losses,
    "equal_distance_ties": _equal_distance_ties,
    "ring_slot_reuse": _ring_reuse,
}


@pytest.mark.parametrize("case", sorted(WASH_CASES))
def test_wash_bitset_model_matches_plain_and_pallas(case):
    loss, sell, buy = WASH_CASES[case]()
    dis, off, has = _check_model(loss, sell, buy)
    if case == "equal_distance_ties":
        assert (off[[40, 40, 31, 50, 64, 63], range(6)]
                == -np.array([1, 30, 31, 7, 3, 17]) * [1, 1, 0, 1, 1, 1]).all()
    if case == "ring_slot_reuse":
        assert (off[[3, 34, 41, 61], range(4)] == -1).all()
        assert (off[[36, 67, 74, 94], range(4)] == 30).all()


_DAY = hst.sampled_from(["none", "at", "above", "buy"])


@pytest.mark.parametrize("S", _PALLAS_S)
@settings(max_examples=12, deadline=None, derandomize=True, database=None)
@given(data=hst.data())
def test_wash_bitset_model_hypothesis(S, data):
    """Hypothesis-made trials: each day a buy of none, exactly 0.001
    shares, the next float above it or a random size, and a loss or not."""
    B = data.draw(hst.integers(1, 5), label="trials")
    kinds = data.draw(hst.lists(_DAY, min_size=S * B, max_size=S * B),
                      label="buys")
    losses = data.draw(hst.lists(hst.booleans(), min_size=S * B,
                                 max_size=S * B), label="losses")
    seed = data.draw(hst.integers(0, 2**31), label="seed")
    rs = np.random.default_rng(seed)
    at = np.float32(0.001)
    table = {"none": 0.0, "at": at, "above": np.nextafter(at, np.inf)}
    buy = np.array([table.get(k, 0.0) if k != "buy"
                    else rs.gamma(2.0, 3.0) for k in kinds],
                   np.float32).reshape(S, B)
    loss = (np.array(losses).reshape(S, B)
            * rs.gamma(2.0, 50.0, (S, B))).astype(np.float32)
    sell = rs.gamma(2.0, 4.0, (S, B)).astype(np.float32)
    _check_model(loss, sell, buy)
