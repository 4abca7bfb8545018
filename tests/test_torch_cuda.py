"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; without a card every test skips (decided inside the
fixture). Nothing here needs JAX. On a GPU machine:
``python -m pytest -m cuda tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from letf_tpu_torch.models import params as tparams
from letf_tpu_torch.models.params import default_sim_model
from letf_tpu_torch.ops import compose_strategies as k3
from letf_tpu_torch.ops import joint, window

pytestmark = pytest.mark.cuda

B, T, S = 2048, 252, 126


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def inputs(dev):
    rs = np.random.default_rng(0)
    half = np.cumsum(rs.random((T, B // 2)) < 0.1, axis=0) % 2
    regime = torch.as_tensor(np.repeat(half, 2, axis=1), dtype=torch.float32,
                             device=dev)
    rows = torch.arange(B, device=dev)
    ids = (rows // 2).to(torch.int32)
    signs = torch.where(rows % 2 == 1, -1.0, 1.0).to(torch.float32)
    offs = torch.as_tensor(rs.integers(0, T - S + 1, B), dtype=torch.int32,
                           device=dev)
    return regime, ids, signs, [9, 11], offs


def test_joint_kernel_matches_plain(dev):
    model = default_sim_model()
    regime, ids, signs, sw, _ = inputs(dev)
    args = (tparams.pack_joint_params(model).to(dev),
            torch.as_tensor(model.joint.chi_cheb, dtype=torch.float32,
                            device=dev), regime, ids, signs, sw)
    n0 = joint.LAUNCHES
    got = joint.joint_generate(*args)
    assert joint.LAUNCHES == n0 + 1
    ref = joint.joint_plain(*args)
    for c in (0, 1, 2, 4):
        torch.testing.assert_close(got[c], ref[c], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(got[3], ref[3], rtol=0, atol=1e-3)


def joint_case(dev, n_trials, days, n_cheb, seed):
    """K1 arguments for n_trials antithetic-paired trials x days: a regime
    path per pair, the model's table, and ``n_cheb`` Chebyshev coefficients
    (the model's 14, cut short or extended by small random terms)."""
    model = default_sim_model()
    rs = np.random.default_rng(seed)
    half = np.cumsum(rs.random((days, (n_trials + 1) // 2)) < 0.1, axis=0) % 2
    regime = np.repeat(half, 2, axis=1)[:, :n_trials]
    cheb = np.asarray(model.joint.chi_cheb, np.float64)
    if n_cheb <= cheb.shape[1]:
        cheb = cheb[:, :n_cheb]
    else:
        extra = 1e-3 * rs.standard_normal((cheb.shape[0],
                                           n_cheb - cheb.shape[1]))
        cheb = np.concatenate([cheb, extra], axis=1)
    rows = torch.arange(n_trials, device=dev)
    return (tparams.pack_joint_params(model).to(dev),
            torch.as_tensor(cheb, dtype=torch.float32, device=dev),
            torch.as_tensor(regime, dtype=torch.float32, device=dev),
            (rows // 2).to(torch.int32),
            torch.where(rows % 2 == 1, -1.0, 1.0).to(torch.float32), [9, 11])


@pytest.mark.parametrize("n_trials,days,n_cheb", [
    (650, T, 14), (33, T, 14), (B, 1, 14), (B, 12 * 7 + 5, 14),
    (256, T, 1), (256, T, 32)])
def test_joint_kernel_matches_plain_edge_cases(dev, n_trials, days, n_cheb):
    """K1 against its plain version where the strip-and-ring design has
    edges: a ragged last 32-trial strip (650, 33 trials), day 0 alone, a
    day count that ends inside a 12-day ring tile, and the shortest and
    longest Chebyshev tables the kernel takes."""
    args = joint_case(dev, n_trials, days, n_cheb, seed=n_trials + days)
    n0 = joint.LAUNCHES
    got = joint.joint_generate(*args)
    assert joint.LAUNCHES == n0 + 1
    ref = joint.joint_plain(*args)
    for c in (0, 1, 2, 4):
        torch.testing.assert_close(got[c], ref[c], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(got[3], ref[3], rtol=0, atol=1e-3)


def test_joint_kernel_bitwise_under_trial_shuffle(dev):
    """Each trial's outputs depend on its own (regime column, id, sign)
    only: the same triples of a paired B = 2,048 in a random order give,
    once un-shuffled, the same bits. No lane reads another strip's or
    another pair's values."""
    params, cheb, regime, ids, signs, sw = joint_case(dev, B, T, 14, seed=3)
    got = joint.joint_generate(params, cheb, regime, ids, signs, sw)
    perm = torch.as_tensor(np.random.default_rng(4).permutation(B),
                           device=dev)
    shuf = joint.joint_generate(params, cheb, regime[:, perm].contiguous(),
                                ids[perm].contiguous(),
                                signs[perm].contiguous(), sw)
    inv = torch.argsort(perm)
    for a, s in zip(got, shuf):
        assert torch.equal(a.view(torch.int32),
                           s[:, inv].contiguous().view(torch.int32))


def math_check(a, b):
    """letf_joint_math_check on float32 operands ``a``, ``b`` ([n], CUDA):
    rows of FastMath a / b, a / b, its range flag (1 or 0), FastMath
    sqrt(a), sqrtf(a), its flag, sin_cos(a)'s sine, sinf(a), its cosine
    and cosf(a), as K1 computes them."""
    from letf_tpu_torch.ops import _build

    out = torch.empty((10, a.numel()), device=a.device)
    _build.check(_build.library().letf_joint_math_check(
        a.data_ptr(), b.data_ptr(), a.numel(), out.data_ptr(),
        _build.stream_of(a)), "letf_joint_math_check")
    return out


def float_bits(dev, bits):
    return torch.as_tensor(np.asarray(bits, np.uint32).view(np.int32),
                           device=dev).view(torch.float32)


def random_floats(dev, rs, exponents, n, signed=True):
    """n float32 of unbiased exponents drawn from ``exponents``, with random
    mantissas (and signs)."""
    e = rs.choice(np.asarray(exponents), n) + 127
    bits = (e << 23) | rs.integers(0, 1 << 23, n)
    if signed:
        bits |= rs.integers(0, 2, n) << 31
    return float_bits(dev, bits)


def same_bits(x, y):
    return torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_joint_fast_division_is_ieee_in_its_range(dev):
    """K1's FastMath.div is ``a / b`` bit for bit wherever its flag holds:
    |a| and |b| in [2^-40, 2^41) at random, mantissas at the ends of a
    binade against each other at the range's ends and middle, and a = +-0.
    Just outside the range (exponents -46..-41 and 41..46 in either
    operand) the flag falls, so K1 recomputes that day by IEEE."""
    rs = np.random.default_rng(8)
    n = 1 << 22
    inside = np.arange(-40, 41)
    a, b = (random_floats(dev, rs, inside, n) for _ in range(2))
    mant = np.array([0, 1, 2, 3, (1 << 22) - 1, 1 << 22, (1 << 23) - 2,
                     (1 << 23) - 1])
    grid = ((np.array([-40, -1, 0, 1, 40])[:, None] + 127) << 23
            | mant).ravel()
    ga, gb = np.repeat(grid, grid.size), np.tile(grid, grid.size)
    neg = np.uint32(1 << 31)
    ga = np.concatenate([ga, ga | neg, ga, 0 * grid, 0 * grid | neg])
    gb = np.concatenate([gb, gb, gb | neg, grid, grid])
    out = math_check(torch.cat([a, float_bits(dev, ga)]),
                     torch.cat([b, float_bits(dev, gb)]))
    assert bool((out[2] == 1).all())
    assert same_bits(out[0], out[1])
    outside = np.r_[-46:-40, 41:47]
    far = random_floats(dev, rs, outside, n // 4)
    near = random_floats(dev, rs, inside, n // 4)
    for x, y in ((far, near), (near, far)):
        assert bool((math_check(x, y)[2] == 0).all())


def test_joint_fast_sqrt_is_ieee_in_its_range(dev):
    """K1's FastMath.sqrt is ``sqrtf`` bit for bit on [2^-101, FLT_MAX]:
    every mantissa of [1, 4) (an even and an odd exponent), random
    operands over the range, and its two ends. Below it (2^-126..2^-102,
    a denormal, +-0), on negatives, inf and NaN the flag falls."""
    rs = np.random.default_rng(9)
    every = (127 << 23) + np.arange(1 << 24)
    x = torch.cat([float_bits(dev, every),
                   random_floats(dev, rs, np.arange(-101, 128), 1 << 22,
                                 signed=False),
                   float_bits(dev, [0x0d000000, 0x7f7fffff])])
    out = math_check(x, x)
    assert bool((out[5] == 1).all())
    assert same_bits(out[3], out[4])
    y = torch.cat([random_floats(dev, rs, np.arange(-126, -101), 1 << 20,
                                 signed=False),
                   float_bits(dev, [0x0cffffff, 1, 0, 0x80000000,
                                    0xbf800000, 0x7f800000, 0x7fc00000])])
    assert bool((math_check(y, y)[5] == 0).all())


def test_joint_sin_cos_is_the_library_fast_path(dev):
    """K1's sin_cos is ``sinf`` and ``cosf`` bit for bit on every
    Box-Muller angle 2 pi u that a counter uniform u = (k + 1/2) 2^-24
    gives (all 2^24 of them, as common.cuh's letf_unit rounds them), and on
    random |x| < 105615, the library's fast-path range."""
    k = torch.arange(1 << 24, device=dev, dtype=torch.int32)
    u = k.to(torch.float32) * (1.0 / 16777216.0) + (0.5 / 16777216.0)
    rs = np.random.default_rng(10)
    x = torch.cat([u * 6.283185307179586,
                   torch.as_tensor(rs.uniform(-105614.0, 105614.0, 1 << 22),
                                   dtype=torch.float32, device=dev)])
    out = math_check(x, x)
    assert same_bits(out[6], out[7])
    assert same_bits(out[8], out[9])


def test_window_kernel_bitwise(dev):
    regime, _, _, _, offs = inputs(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    xs = [torch.randn((T, B), generator=g, device=dev) for _ in range(5)]
    xs[0][3, 7] = float("nan")
    xs.append(regime)
    bias = [torch.randn(B, generator=g, device=dev) for _ in range(3)]
    n0 = window.LAUNCHES
    got = window.window_offsets(xs, offs, S, biases=bias + [None] * 3)
    assert window.LAUNCHES == n0 + 1
    ref = window.window_plain(xs, offs, S, biases=bias + [None] * 3)
    for a, b in zip(got, ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("case", ["ragged", "equal", "wide"])
def test_window_kernel_bitwise_edge_cases(dev, case):
    """K2 bitwise against its plain version where the strip design has
    edges: a B that is neither a multiple of 32 nor of 4 (a masked last
    strip, 4-byte copies), every offset equal (a span of one row), and
    spans wider than one 32-trial ring holds (narrower sub-strips)."""
    Bc, Tc, Sc = {"ragged": (650, T, S), "equal": (B, T, S),
                  "wide": (512, 2520 + 3000, 2520)}[case]
    g = torch.Generator(device=dev).manual_seed(2)
    xs = [torch.randn((Tc, Bc), generator=g, device=dev) for _ in range(3)]
    xs[1][4, Bc - 1] = float("nan")
    xs[2][5, 0] = -0.0
    offs = (torch.full((Bc,), (Tc - Sc) // 3, dtype=torch.int32, device=dev)
            if case == "equal" else
            torch.randint(0, Tc - Sc + 1, (Bc,), generator=g, device=dev,
                          dtype=torch.int32))
    bias = [torch.randn(Bc, generator=g, device=dev), None, None]
    n0 = window.LAUNCHES
    got = window.window_offsets(xs, offs, Sc, biases=bias)
    assert window.LAUNCHES == n0 + 1
    for a, b in zip(got, window.window_plain(xs, offs, Sc, biases=bias)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("n_trials", [1024, 1000])
def test_compose_strategies_kernel_matches_plain_one_year(dev, n_trials):
    """K3 against its plain version at 1,024 trials x 252 days, and at a
    trial count that leaves the last 32-trial block ragged."""
    model = default_sim_model()
    rs = np.random.default_rng(7)
    Sy = 252
    spy = 0.0003 + 0.012 * rs.standard_t(5, (Sy, n_trials))
    vix = np.clip(20.0 - 30.0 * np.cumsum(spy - 0.0003, 0)
                  + 3.0 * rs.standard_normal((Sy, n_trials)), 9.0, 80.0)
    regime = np.cumsum(rs.random((Sy, n_trials)) < 0.05, 0) % 2
    chans = [torch.as_tensor(c, dtype=torch.float32, device=dev)
             for c in (spy, 1.2 * spy, -0.2 * spy, vix,
                       np.full((Sy, n_trials), 3.0), regime)]
    args = (tparams.pack_stress_params(model).to(dev),
            tparams.pack_asset_params(model).to(dev),
            (torch.arange(n_trials, device=dev) // 2).to(torch.int32),
            [9, 11], *chans)
    got = [g.cpu().numpy() for g in k3.compose_strategies(*args)]
    ref = [r.cpu().numpy() for r in k3.compose_strategies_plain(*args)]
    k3.check_parity(dict(zip(k3.OUTPUTS, got)), dict(zip(k3.OUTPUTS, ref)),
                    exact=("path_finite", "vix_min", "vix_max",
                           "regime_high_days"))


@pytest.mark.parametrize("n_trials", [1024, 1000])
def test_compose_strategies_kernel_bitwise_k4_fused(dev, n_trials):
    """K3 (the slab chunk) runs K4's day math split over warps, so on the
    same trials the slab path's summaries are bitwise those of the general
    path through K4's fused-signals mode (whose composition is K5's, the
    same day math as K3's)."""
    from letf_tpu_torch.ops import rng
    from letf_tpu_torch.ops import strategies as k4
    from letf_tpu_torch.ops.path_batched import generate_paths_batched
    from letf_tpu_torch.ops.slab_chunk import slab_chunk_summaries
    from letf_tpu_torch.strategies.signals import compute_signals

    mt = tparams.from_numpy(default_sim_model(), dev, torch.float32)
    rows = torch.arange(n_trials, device=dev)
    ids, anti, key = rows // 2, rows % 2 == 1, rng.key(6, dev)
    p = generate_paths_batched(mt, key, ids, anti, sim_days=252,
                               buffer_days=126)
    chans = k4.channels_from(p, compute_signals(p))[:k4.N_FUSED]
    got = k4.strategies_run(chans, fused_signals=True)
    n0 = k3.LAUNCHES
    sm = slab_chunk_summaries(mt, key, ids, anti, sim_days=252,
                              buffer_days=126)
    assert k3.LAUNCHES == n0 + 1
    for a, name in zip(got, ("final_wealth", "num_trades", "max_dd")):
        assert torch.equal(a.view(torch.int32), sm[name].view(torch.int32)), \
            name


@pytest.mark.parametrize("with_cashflows,apply_costs",
                         [(False, True), (True, True), (False, False)])
def test_compose_strategies_kernel_matches_plain(dev, with_cashflows,
                                                 apply_costs):
    model = default_sim_model()
    rs = np.random.default_rng(5)
    spy = 0.0003 + 0.012 * rs.standard_t(5, (S, B))
    vix = np.clip(20.0 - 30.0 * np.cumsum(spy - 0.0003, 0)
                  + 3.0 * rs.standard_normal((S, B)), 9.0, 80.0)
    regime = np.cumsum(rs.random((S, B)) < 0.05, 0) % 2
    chans = [torch.as_tensor(c, dtype=torch.float32, device=dev)
             for c in (spy, 1.2 * spy, -0.2 * spy, vix,
                       np.full((S, B), 3.0), regime)]
    ids = (torch.arange(B, device=dev) // 2).to(torch.int32)
    cf = (torch.full((S,), 750.0, device=dev) * (torch.arange(S, device=dev)
                                                  % 21 == 0)
          if with_cashflows else None)
    args = (tparams.pack_stress_params(model).to(dev),
            tparams.pack_asset_params(model).to(dev), ids, [9, 11], *chans)
    n0 = k3.LAUNCHES
    got = [g.cpu().numpy() for g in k3.compose_strategies(
        *args, cashflows=cf, apply_costs=apply_costs)]
    assert k3.LAUNCHES == n0 + 1
    ref = [r.cpu().numpy() for r in k3.compose_strategies_plain(
        *args, cashflows=cf, apply_costs=apply_costs)]
    k3.check_parity(dict(zip(k3.OUTPUTS, got)), dict(zip(k3.OUTPUTS, ref)),
                    exact=("path_finite", "vix_min", "vix_max",
                           "regime_high_days"))


def compose_args(dev, S, B, seed=6):
    """K5's inputs: t-distributed SPY (QQQ and TLT scaled from it), a VIX
    around 20, IRX 3, a regime switching ~5% of days; antithetic ids."""
    model = default_sim_model()
    rs = np.random.default_rng(seed)
    spy = 0.0003 + 0.012 * rs.standard_t(5, (S, B))
    vix = np.clip(20.0 + 8.0 * rs.standard_normal((S, B)), 9.0, 80.0)
    regime = np.cumsum(rs.random((S, B)) < 0.05, 0) % 2
    chans = [torch.as_tensor(c, dtype=torch.float32, device=dev)
             for c in (spy, 1.2 * spy, -0.2 * spy, vix,
                       np.full((S, B), 3.0), regime)]
    return (tparams.pack_stress_params(model).to(dev),
            tparams.pack_asset_params(model).to(dev),
            (torch.arange(B, device=dev) // 2).to(torch.int32), [9, 11],
            *chans)


def test_compose_kernel_matches_plain(dev):
    """K5 within rtol 1e-5 / atol 1e-6 of its plain version on the card
    (torch divides by a Python scalar as a multiply by its reciprocal)."""
    from letf_tpu_torch.ops import compose

    args = compose_args(dev, S, B)
    n0 = compose.LAUNCHES
    got = compose.compose_generate(*args)
    assert compose.LAUNCHES == n0 + 1
    ref = compose.compose_plain(*args)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_trials", [1, 33, 650])
@pytest.mark.parametrize("days", [1, 5, 40])
def test_compose_kernel_ragged_shapes(dev, n_trials, days):
    """K5 at ragged trial counts (one lane, a strip and a lane, the
    report's 650) and at day counts shorter than one ring tile (16 days)
    or than the ring (2 tiles), within the same bounds as above."""
    from letf_tpu_torch.ops import compose

    args = compose_args(dev, days, n_trials, seed=n_trials + days)
    got = compose.compose_generate(*args)
    ref = compose.compose_plain(*args)
    assert got[0].shape == (6, days, n_trials)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def load_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_compose_kernel_matches_first_port_digests(dev):
    """K5 bit for bit the first port's kernel on chip_smoke.phase_k5's
    inputs (the chunk's windowed K1 channels, 7,560 days): all 16,384
    trials and the report's first 650 (chip_smoke.K5_DIGESTS_FIRST_PORT)."""
    from letf_tpu_torch.ops import compose

    smoke = load_smoke()
    mt = tparams.from_numpy(default_sim_model(), dev, torch.float32)
    sim, buf = smoke.FULL["sim"], smoke.FULL["buf"]
    regime, ids, signs, sw, offs = smoke.chain_inputs(mt, smoke.B_CHUNK, sim,
                                                      buf)
    xk = joint.joint_generate(*smoke.joint_args(mt, regime, ids, signs, sw))
    chans = smoke.windowed(mt, list(xk) + [regime], offs, sim)
    del xk
    ka = smoke.k3_args(mt, ids, sw, chans)
    rb = smoke.K5_REPORT_B
    kr = (*ka[:2], ka[2][:rb].contiguous(), ka[3],
          *(c[:, :rb].contiguous() for c in ka[4:]))
    got = {"chunk": [smoke.bit_digest(x)
                     for x in compose.compose_generate(*ka)],
           "report": [smoke.bit_digest(x)
                      for x in compose.compose_generate(*kr)]}
    assert got == smoke.K5_DIGESTS_FIRST_PORT


@pytest.mark.parametrize("kind", ["merge", "valley"])
def test_sort_bridge_kernel_bitwise(dev, kind):
    from letf_tpu_torch.ops import sort_bridge as k7

    g = torch.Generator(device=dev).manual_seed(3)
    R, half = 300, 700
    N = 2 * half
    f64 = dict(generator=g, device=dev, dtype=torch.float64)
    key = torch.round(torch.randn((N, R), **f64).abs() * 4) / 4
    key[half:] = torch.sort(key[half:], dim=0).values
    if kind == "merge":
        key[:half] = torch.sort(key[:half], dim=0).values
    pos = torch.arange(N, device=dev, dtype=torch.int32)
    sec = torch.where(pos >= half, pos | (1 << 24), pos)[:, None].expand(
        N, R).contiguous()
    pays = tuple(torch.randn((N, R), **f64) for _ in range(4))
    n0 = k7.LAUNCHES
    got = k7.sort_bridge(key, sec, pays, kind=kind)
    assert k7.LAUNCHES == n0 + 1
    for a, b in zip(got, k7.sort_bridge_plain(key, sec, pays)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("R,half,n_pay,kind", [
    (1, 1, 0, "merge"), (33, 5, 3, "valley"), (650, 7560, 2, "merge"),
    (97, 7560, 4, "valley"), (64, 12600, 2, "merge")])
def test_sort_bridge_kernel_shapes(dev, R, half, n_pay, kind):
    """K7 bitwise its plain version at ragged shapes, the bridge's 30-year
    half and the 50-year one (the permutation in device scratch there);
    the valley kind with zero head payloads, as the bridge calls it."""
    from letf_tpu_torch.ops import sort_bridge as k7

    g = torch.Generator(device=dev).manual_seed(R + half)
    N = 2 * half
    f64 = dict(generator=g, device=dev, dtype=torch.float64)
    key = torch.round(torch.randn((N, R), **f64).abs() * 4) / 4
    key[::7] = torch.where(key[::7] > 1, float("inf"), key[::7])
    key[half:] = torch.sort(key[half:], dim=0).values
    if kind == "merge":
        key[:half] = torch.sort(key[:half], dim=0).values
    pos = torch.arange(N, device=dev, dtype=torch.int32)
    sec = torch.where(pos >= half, pos | (1 << 24), pos)[:, None].expand(
        N, R).contiguous()
    pays = tuple(torch.randn((N, R), **f64) for _ in range(n_pay))
    hz = kind == "valley"
    for p in pays if hz else ():
        p[:half] = 0.0
    n0 = k7.LAUNCHES
    got = k7.sort_bridge(key, sec, pays, kind=kind, head_payloads_zero=hz)
    assert k7.LAUNCHES == n0 + 1
    for a, b in zip(got, k7.sort_bridge_plain(key, sec, pays)):
        assert torch.equal(a, b)


def test_sort_bridge_kernel_int64_key_without_sec(dev):
    """An int64 primary and no secondary: equal keys keep the first
    half first."""
    from letf_tpu_torch.ops import sort_bridge as k7

    g = torch.Generator(device=dev).manual_seed(9)
    R, half = 130, 300
    key = torch.randint(0, 40, (2 * half, R), generator=g, device=dev,
                        dtype=torch.int64)
    key[:half] = torch.sort(key[:half], dim=0).values
    key[half:] = torch.sort(key[half:], dim=0).values
    pay = torch.randn((2 * half, R), generator=g, device=dev,
                      dtype=torch.float64)
    got = k7.sort_bridge(key, None, (pay,), kind="merge")
    for a, b in zip(got, k7.sort_bridge_plain(key, None, (pay,))):
        assert torch.equal(a, b)


def test_sort_bridge_kernel_raises_beyond_its_limit(dev):
    """A half longer than the kernel's shared memory takes raises; the
    plain version is never run in its place."""
    from letf_tpu_torch.ops import sort_bridge as k7

    half = 14_529
    key = torch.zeros((2 * half, 2), dtype=torch.float64, device=dev)
    sec = torch.zeros((2 * half, 2), dtype=torch.int32, device=dev)
    n0 = k7.LAUNCHES
    for kind in ("merge", "valley"):
        with pytest.raises(ValueError, match="shared memory"):
            k7.sort_bridge(key, sec, (), kind=kind)
    assert k7.LAUNCHES == n0


def test_wash_kernel_bitwise(dev):
    from letf_tpu_torch.ops import wash

    g = torch.Generator(device=dev).manual_seed(4)

    def sparse(p, scale):
        f64 = dict(generator=g, device=dev, dtype=torch.float64)
        u = torch.rand((S, B), **f64)
        return torch.where(u < p, torch.rand((S, B), **f64) * scale, 0.0)

    buy, sell = sparse(0.25, 6.0), sparse(0.15, 8.0)
    loss = torch.where(sell > 0, sparse(0.5, 100.0), 0.0)
    n0 = wash.LAUNCHES
    got = wash.wash_matching(loss, sell, buy)
    assert wash.LAUNCHES == n0 + 1
    for a, b in zip(got, wash.wash_plain(loss, sell, buy)):
        assert torch.equal(a, b)


def wash_edge_case(name, S, B, seed):
    """[S, B] float64 (loss, sell, buy) of one K8 edge case (the CPU tests'
    cases in tests/test_torch_wash.py, at any trial count)."""
    rs = np.random.default_rng(seed)
    p_buy, p_loss = {"every_day_a_loss": (0.25, 1.0),
                     "buys_every_day": (1.0, 0.4)}.get(name, (0.25, 0.1))
    buy = np.where(rs.random((S, B)) < p_buy, rs.gamma(2.0, 3.0, (S, B)), 0.0)
    sell = rs.gamma(2.0, 4.0, (S, B))
    loss = np.where(rs.random((S, B)) < p_loss, rs.gamma(2.0, 50.0, (S, B)),
                    0.0)
    at = np.float64(0.001)
    if name == "buys_at_the_threshold":
        pick = rs.integers(0, 3, (S, B))
        buy = np.where(pick == 0, at,
                       np.where(pick == 1, np.nextafter(at, np.inf), 0.0))
    elif name == "first_and_last_day_losses":
        loss[:] = 0.0
        loss[[0, S - 1]] = 50.0
        buy[:] = 0.0
        buy[[1, 30, 31, S - 2, S - 31, S - 32]] = 2.0
    elif name == "equal_distance_ties":
        loss[:] = 0.0
        buy[:] = 0.0
        for b in range(B):
            d, k = 32 + b % 40, 1 + b % 31
            loss[[d, d + 1], b] = (10.0, 20.0)
            buy[[d - k, d + k], b] = (1.0, 100.0)
    elif name == "ring_slot_reuse":
        loss[:] = 0.0
        buy[:] = 0.0
        for b in range(B):
            x = b % 60
            buy[[x, x + 64], b] = 3.0
            loss[[x + 1, x + 34], b] = 7.0
    return [torch.as_tensor(a, dtype=torch.float64) for a in (loss, sell, buy)]


WASH_EDGE = {"one_day": 1, "shorter_than_the_window": 45, "ragged_days": 97,
             "every_day_a_loss": 150, "buys_every_day": 97,
             "buys_at_the_threshold": 97, "first_and_last_day_losses": 97,
             "equal_distance_ties": 150, "ring_slot_reuse": 150}


@pytest.mark.parametrize("n_trials", [1, 33, 650])
@pytest.mark.parametrize("case", sorted(WASH_EDGE))
def test_wash_kernel_bitwise_edge_cases(dev, case, n_trials):
    """K8's day bitsets, loss-day walk and epilogue bitwise its plain
    version on the CPU tests' edge cases at 1, 33 and 650 trials."""
    from letf_tpu_torch.ops import wash

    args = [a.to(dev) for a in wash_edge_case(case, WASH_EDGE[case],
                                              n_trials, 12)]
    n0 = wash.LAUNCHES
    got = wash.wash_matching(*args)
    assert wash.LAUNCHES == n0 + 1
    for a, b in zip(got, wash.wash_plain(*args)):
        assert torch.equal(a, b)


def test_emitting_engine_refuses_without_emission_on_the_card(dev):
    """Without emission the engine is kernel K4 on the card (one launch),
    never the plain loop; its summaries agree with the emitting engine's
    on the same path within compose_strategies.check_parity's bounds."""
    from letf_tpu_torch.ops import rng
    from letf_tpu_torch.ops import strategies as k4
    from letf_tpu_torch.ops.path_batched import generate_paths_batched
    from letf_tpu_torch.parallel.mc_runner import from_numpy
    from letf_tpu_torch.strategies.engine import run_strategies_batch
    from letf_tpu_torch.strategies.signals import compute_signals

    mt = from_numpy(default_sim_model(), dev, torch.float32)
    rows = torch.arange(64, device=dev)
    path = generate_paths_batched(mt, rng.key(1, dev), rows // 2,
                                  rows % 2 == 1, sim_days=S)
    sig = compute_signals(path)
    n0 = k4.LAUNCHES
    got = run_strategies_batch(path, sig, emit_trades=False)
    assert k4.LAUNCHES == n0 + 1 and got.tj_alloc is None
    ref = run_strategies_batch(path, sig, emit_trades=True)
    k3.check_parity(got._asdict(), ref._asdict())


@pytest.mark.parametrize("fused,with_cashflows",
                         [(False, False), (False, True), (True, False)])
def test_strategies_kernel_matches_plain(dev, fused, with_cashflows):
    """K4 in both modes (and with a DCA schedule) against its plain
    version, within check_parity's bounds."""
    from letf_tpu_torch.ops import rng
    from letf_tpu_torch.ops import strategies as k4
    from letf_tpu_torch.ops.path_batched import generate_paths_batched
    from letf_tpu_torch.strategies.signals import compute_signals

    mt = tparams.from_numpy(default_sim_model(), dev, torch.float32)
    rows = torch.arange(B, device=dev)
    path = generate_paths_batched(mt, rng.key(4, dev), rows // 2,
                                  rows % 2 == 1, sim_days=T)
    chans = k4.channels_from(path, compute_signals(path))
    if fused:
        chans = chans[:k4.N_FUSED]
    cf = ((torch.arange(T, device=dev) % 21 == 0) * 500.0).float() \
        if with_cashflows else None
    n0 = k4.LAUNCHES
    got = k4.strategies_run(chans, cashflows=cf, fused_signals=fused)
    assert k4.LAUNCHES == n0 + 1
    ref = k4.strategies_plain(chans, cashflows=cf, fused_signals=fused)
    names = ("final_wealth", "num_trades", "max_dd")
    k3.check_parity(dict(zip(names, got)), dict(zip(names, ref)))


@pytest.mark.parametrize("cashflows,apply_costs", [(False, True),
                                                 (True, False)])
@pytest.mark.parametrize("n_trials,days", [(1, 1), (31, 7), (33, 100),
                                           (100, 21), (650, 13)])
def test_strategies_kernel_ragged_shapes(dev, n_trials, days, cashflows,
                                         apply_costs):
    """K4's channel mode (a block of four group warps over 32 trials, an
    8-day staged tile; 16-byte copies when B is a multiple of 4, else 4-byte
    ones) at ragged trial and day counts against its plain version."""
    from letf_tpu_torch.ops import rng
    from letf_tpu_torch.ops import strategies as k4
    from letf_tpu_torch.ops.path_batched import generate_paths_batched
    from letf_tpu_torch.strategies.signals import compute_signals

    mt = tparams.from_numpy(default_sim_model(), dev, torch.float32)
    rows = torch.arange(n_trials, device=dev)
    path = generate_paths_batched(mt, rng.key(5, dev), rows // 2,
                                  rows % 2 == 1, sim_days=126,
                                  buffer_days=126)
    chans = [c[:days] for c in k4.channels_from(path, compute_signals(path))]
    cf = (((torch.arange(days, device=dev) % 5 == 0) * 400.0
           - (torch.arange(days, device=dev) % 7 == 6) * 900.0).float()
          if cashflows else None)
    n0 = k4.LAUNCHES
    got = k4.strategies_run(chans, cashflows=cf, apply_costs=apply_costs)
    assert k4.LAUNCHES == n0 + 1
    ref = k4.strategies_plain(chans, cashflows=cf, apply_costs=apply_costs)
    names = ("final_wealth", "num_trades", "max_dd")
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (n_trials, 19)
    k3.check_parity(dict(zip(names, got)), dict(zip(names, ref)))


def test_strategies_kernel_matches_first_port_digests(dev):
    """K4 bit for bit the first port's kernel on the parametric chunk's
    channels (16,384 x 7,560): chip_smoke.K4_DIGESTS_FIRST_PORT, in
    channel mode, fused-signals mode and with cashflows and no costs."""
    smoke = load_smoke()
    mt = tparams.from_numpy(default_sim_model(), dev, torch.float32)
    _, chans = smoke.parametric_breakdown(mt)
    assert smoke.k4_digests(chans) == smoke.K4_DIGESTS_FIRST_PORT


def test_kernel_info_reports_every_kernel(dev):
    """letf_kernel_info: every kernel of the library fits on an SM at its
    launch shape; K3 keeps more than 4 warps resident an SM (its 72
    registers and 24 local bytes unchanged since PR 4), K1 at least 12 (4
    blocks of one recurrence and three draw warps), K4's channel mode and
    K5 at least 16 (4 blocks of four warps), all three without spilling,
    K6 uses no local memory (no Payne-Hanek reduction), K7 none (no
    runtime-indexed parameter array) and the emitting day kernel none (its
    chunk of days stays in registers)."""
    from letf_tpu_torch.ops import _build

    info = _build.kernel_info()
    assert set(info) == set(_build.KERNEL_INFO)
    for name, v in info.items():
        assert v["registers"] > 0 and v["blocks_per_sm"] >= 1, (name, v)
    assert info["compose_strategies"]["warps_per_sm"] > 4, info
    assert info["joint"]["warps_per_sm"] >= 12, info
    assert info["joint"]["local_bytes"] == 0, info
    assert info["strategies"]["warps_per_sm"] >= 16, info
    assert info["strategies"]["local_bytes"] == 0, info
    k3 = info["compose_strategies"]
    assert (k3["registers"], k3["local_bytes"]) == (72, 24), k3
    assert info["compose"]["warps_per_sm"] >= 16, info
    assert info["compose"]["local_bytes"] == 0, info
    assert info["gbm"]["local_bytes"] == 0, info
    assert info["merge"]["local_bytes"] == 0, info
    assert info["emit_days"]["local_bytes"] == 0, info


def test_gbm_kernel_matches_plain(dev):
    """K6 against its plain version: the same counter bits and float32
    operations (wealth within rtol 1e-5, drawdown within 1e-5), at 252
    days, an odd 63, and on the ruin path (a drift that keeps net on the
    -0.999 floor: blocks of 6 pairs, wealth 0, drawdown 1)."""
    from letf_tpu_torch.ops import gbm

    for args in ((5, 8192, 252, 0.0004, 0.015, 3.0, 3e-5),
                 (5, 8192, 63, 0.0004, 0.015, 3.0, 3e-5),
                 (2, 4096, 30, -0.5, 0.05, 3.0, 0.0)):
        n0 = gbm.LAUNCHES
        w, m = gbm.gbm_buyhold(*args, device=dev)
        assert gbm.LAUNCHES == n0 + 1
        wp, mp = gbm.gbm_plain(*args, device=dev)
        torch.testing.assert_close(w, wp, rtol=1e-5, atol=0)
        torch.testing.assert_close(m, mp, rtol=0, atol=1e-5)
    assert (w == 0).all() and (m == 1).all()
