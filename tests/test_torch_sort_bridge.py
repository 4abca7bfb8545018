"""Kernel K7 (the bridge's column sorts) of the port: its plain PyTorch
version against ``pallas_sort.sort_bridge`` in interpret mode, bitwise.

As tests/test_pallas_sort.py does for the Pallas networks: non-negative
float32 keys with heavy ties, the bridge's unique packed secondary
(tag << 24) | position, every kind, 0/2/4/5 payloads, head_payloads_zero,
zero and +inf keys, the int32 restore-sort form, and the float64 keys of
the CPU parity suite against ``lax.sort``. The port keeps the day axis
first, so its [N, R] columns are the reference's [R, N] rows transposed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu.ops.pallas_sort import sort_bridge as jax_sort_bridge
from letf_tpu_torch.ops.sort_bridge import sort_bridge, sort_bridge_plain
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _mk(rng, R, S, kind, n_pay, head_zero=False):
    N = 2 * S
    key = np.abs(rng.standard_normal((R, N)).astype(np.float32))
    key = np.round(key * 4) / 4
    key[:, S:] = np.sort(key[:, S:], axis=1)
    if kind == "merge":
        key[:, :S] = np.sort(key[:, :S], axis=1)
    tag = (np.arange(N) >= S).astype(np.int32)
    sec = np.broadcast_to((tag << 24) | np.arange(N, dtype=np.int32),
                          (R, N)).copy()
    pays = [rng.standard_normal((R, N)).astype(np.float32)
            for _ in range(n_pay)]
    if head_zero:
        for p in pays:
            p[:, :S] = 0.0
    return key, sec, pays


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a).T))


def _check(key, sec, pays, kind, head_zero=False):
    want = jax_sort_bridge(jnp.asarray(key), None if sec is None
                           else jnp.asarray(sec),
                           tuple(jnp.asarray(p) for p in pays), kind=kind,
                           interpret=True, head_payloads_zero=head_zero)
    got = sort_bridge(_t(key), None if sec is None else _t(sec),
                      tuple(_t(p) for p in pays), kind=kind,
                      head_payloads_zero=head_zero)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().T, np.asarray(w))


@pytest.mark.parametrize("kind", ["merge", "valley", "sort"])
@pytest.mark.parametrize("n_pay", [0, 2, 4, 5])
def test_sort_bridge_plain_bitwise(kind, n_pay):
    rng = np.random.default_rng(7)
    _check(*_mk(rng, 130, 13, kind, n_pay), kind)


def test_sort_bridge_head_payloads_zero():
    rng = np.random.default_rng(17)
    _check(*_mk(rng, 64, 24, "valley", 3, head_zero=True), "valley",
           head_zero=True)


def test_sort_bridge_zero_and_inf_keys():
    R, S = 128, 8
    N = 2 * S
    key = np.zeros((R, N), np.float32)
    key[::3, S:] = np.inf
    tag = (np.arange(N) >= S).astype(np.int32)
    sec = np.broadcast_to((tag << 24) | np.arange(N, dtype=np.int32),
                          (R, N)).copy()
    pay = np.arange(R * N, dtype=np.float32).reshape(R, N)
    for kind in ("merge", "valley"):
        _check(key, sec, [pay], kind)


def test_sort_bridge_i32_primary():
    rng = np.random.default_rng(11)
    R, N = 128, 32
    perm = np.stack([rng.permutation(N) for _ in range(R)]).astype(np.int32)
    pay = rng.standard_normal((R, N)).astype(np.float32)
    _check((perm << 2) | 1, None, [pay], "sort")


@pytest.mark.parametrize("kind", ["merge", "valley"])
def test_sort_bridge_float64_matches_lax_sort(kind):
    """The CPU parity suite's float64 keys: two stable passes (sec, then
    key) equal lax.sort(num_keys=2, is_stable=True)."""
    rng = np.random.default_rng(5)
    key, sec, pays = _mk(rng, 40, 30, kind, 2)
    key = key.astype(np.float64) + 1e-12 * (key > 1)
    pays = [p.astype(np.float64) for p in pays]
    want = jax.lax.sort((jnp.asarray(key), jnp.asarray(sec))
                        + tuple(jnp.asarray(p) for p in pays), dimension=1,
                        num_keys=2, is_stable=True)
    got = sort_bridge_plain(_t(key), _t(sec), tuple(_t(p) for p in pays),
                            kind=kind)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().T, np.asarray(w))


# A numpy transcription of the CUDA kernel (csrc/merge.cu) and its
# wrapper's valley head sort: the halves staged trial-major, each trial's
# merge cut at merge-path splits (one run of outputs a thread, its start
# found by a binary search), the output permutation, and every array moved
# through it (a zero head payload read as zeros). It cannot run the kernel
# here; it holds the algorithm bitwise to the Pallas kernel and the plain
# version, and the card tests hold the kernel to the plain version.
def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a.astype(np.int32)


def k7_model(key, sec, pays, kind, head_zero=False, threads=1024):
    """[2S, R] day-major columns (the port's layout) -> the merged
    (key, sec, *payloads) as the kernel computes them."""
    N, R = key.shape
    S = N // 2
    has_sec = sec is not None
    arrays = [key, *((sec,) if has_sec else ()), *pays]
    dtypes = [a.dtype for a in arrays]
    words = [_bits(a) for a in arrays]
    hz = [False] * (1 + has_sec) + [head_zero and kind == "valley"] * len(pays)
    if kind == "valley":
        # The wrapper's torch.sort of the head by (key, sec), stable.
        for r in range(R):
            order = sorted(range(S), key=lambda i: (
                words[0][i, r], words[1][i, r] if has_sec else 0, i))
            for c, w in enumerate(words):
                if not hz[c]:
                    w[:S, r] = w[:S, r][order]
    tm = np.zeros((len(words), R, N), np.int32)
    for c, w in enumerate(words):          # to_trial_major, per half
        if not hz[c]:
            tm[c, :, :S] = w[:S].T
        tm[c, :, S:] = w[S:].T
    per = -(-N // threads)
    for r in range(R):                     # merge_trial, one block a trial
        ks = tm[0, r].copy()
        ss = tm[1, r].copy() if has_sec else np.zeros(N, np.int32)

        def before(a, b):                  # element a strictly first
            return (ks[a], ss[a]) < (ks[b], ss[b])

        perm = np.full(N, -1)
        for t in range(threads):
            d0, d1 = min(N, t * per), min(N, t * per + per)
            if d0 >= d1:
                continue
            lo, hi = max(0, d0 - S), min(d0, S)
            while lo < hi:
                mid = (lo + hi) // 2
                if not before(S + d0 - 1 - mid, mid):
                    lo = mid + 1
                else:
                    hi = mid
            i, j = lo, S + d0 - lo
            for k in range(d0, d1):
                take_tail = i >= S or (j < N and before(j, i))
                perm[k] = j if take_tail else i
                j, i = (j + 1, i) if take_tail else (j, i + 1)
        assert sorted(perm) == list(range(N))
        for c in range(len(words)):
            row = tm[c, r][perm]
            if hz[c]:
                row[perm < S] = 0
            tm[c, r] = row
    out = [np.ascontiguousarray(tm[c].T).view(dt) if dt == np.float32
           else np.ascontiguousarray(tm[c].T).astype(dt)
           for c, dt in enumerate(dtypes)]
    return tuple(out)


def _check_model(key, sec, pays, kind, head_zero=False, threads=1024):
    """key/sec/pays in the reference's [R, N] layout."""
    want = jax_sort_bridge(jnp.asarray(key), None if sec is None
                           else jnp.asarray(sec),
                           tuple(jnp.asarray(p) for p in pays), kind=kind,
                           interpret=True, head_payloads_zero=head_zero)
    plain = sort_bridge_plain(_t(key), None if sec is None else _t(sec),
                              tuple(_t(p) for p in pays), kind=kind)
    got = k7_model(np.ascontiguousarray(key.T),
                   None if sec is None else np.ascontiguousarray(sec.T),
                   [np.ascontiguousarray(p.T) for p in pays], kind,
                   head_zero, threads)
    assert len(got) == len(want) == len(plain)
    for g, w, p in zip(got, want, plain):
        np.testing.assert_array_equal(g.T.view(np.int32),
                                      np.asarray(w).view(np.int32))
        np.testing.assert_array_equal(g, p.numpy())


@pytest.mark.parametrize("threads", [1024, 7, 3])
@pytest.mark.parametrize("kind,n_pay,head_zero", [
    ("merge", 2, False), ("merge", 0, False), ("valley", 4, True),
    ("valley", 2, False)])
def test_kernel_model_bitwise(kind, n_pay, head_zero, threads):
    """Heavy ties in the key, so the secondary decides; the splits land
    inside runs of equal keys."""
    rng = np.random.default_rng(23 + n_pay)
    _check_model(*_mk(rng, 24, 19, kind, n_pay, head_zero), kind,
                 head_zero, threads)


def test_kernel_model_zero_inf_and_i32_keys():
    R, S = 16, 12
    N = 2 * S
    key = np.zeros((R, N), np.float32)
    key[::3, S:] = np.inf
    key[1::3, :S] = np.inf
    key[2::3, 5:S] = 0.5
    tag = (np.arange(N) >= S).astype(np.int32)
    sec = np.broadcast_to((tag << 24) | np.arange(N, dtype=np.int32),
                          (R, N)).copy()
    pay = np.arange(R * N, dtype=np.float32).reshape(R, N)
    for kind in ("merge", "valley"):
        for threads in (1024, 5):
            _check_model(key, sec, [pay], kind, threads=threads)
    # An int32 primary without a secondary (ties keep the first half
    # first).
    rng = np.random.default_rng(3)
    ik = np.sort(rng.integers(0, 6, (R, N)).astype(np.int32), axis=1)
    ik[:, S:] = np.sort(rng.integers(0, 6, (R, S)).astype(np.int32), axis=1)
    ik[:, :S] = np.sort(ik[:, :S], axis=1)
    got = k7_model(np.ascontiguousarray(ik.T), None,
                   [np.ascontiguousarray(pay.T)], "merge", threads=4)
    plain = sort_bridge_plain(_t(ik), None, (_t(pay),), kind="merge")
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p.numpy())


def test_kernel_model_fifty_years():
    """The reference's 50-year horizon (12,600 days a half; the kernel
    keeps the permutation in device scratch there), bridge-like keys: the
    cumulative shares of the two halves, with long runs of equal values."""
    rng = np.random.default_rng(50)
    R, S = 2, 12_600
    N = 2 * S
    lots = np.cumsum(rng.random((R, S)) < 0.05, axis=1).astype(np.float32)
    sells = np.cumsum(rng.random((R, S)) < 0.03, axis=1).astype(np.float32)
    key = np.concatenate([lots, sells], axis=1)
    tag = (np.arange(N) >= S).astype(np.int32)
    sec = np.broadcast_to((tag << 24) | np.arange(N, dtype=np.int32),
                          (R, N)).copy()
    pays = [rng.standard_normal((R, N)).astype(np.float32)
            for _ in range(2)]
    _check_model(key, sec, pays, "merge")


@pytest.mark.parametrize("S, has_sec, want", [
    (7560, True, (181_440, True)),        # 30 y: sec and perm in shared
    (9685, True, (232_440, False)),       # sec in, perm outside
    (9686, True, (154_976, True)),        # sec leaves, perm in
    (12600, True, (201_600, False)),      # 50 y: keys alone
    (7560, False, (120_960, True)),
    (11000, False, (176_000, True)),      # 44 y without sec: perm in
    (12600, False, (201_600, False)),     # 50 y without sec: perm outside
])
def test_merge_limit_mirrors_the_kernel(S, has_sec, want):
    """ops/sort_bridge._merge_limit: the shared bytes and permutation
    placement of csrc/merge.cu's merge_smem (64-bit keys)."""
    from letf_tpu_torch.ops.sort_bridge import _merge_limit

    assert _merge_limit(S, has_sec) == want


@pytest.mark.parametrize("S, has_sec", [
    (14529, True), (14529, False), (29057, False)])
def test_merge_limit_raises_beyond_the_kernel(S, has_sec):
    from letf_tpu_torch.ops.sort_bridge import _merge_limit

    with pytest.raises(ValueError, match="shared"):
        _merge_limit(S, has_sec)
