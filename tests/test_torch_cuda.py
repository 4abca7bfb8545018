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


def test_compose_kernel_matches_plain(dev):
    """K5 within rtol 1e-5 / atol 1e-6 of its plain version on the card
    (torch divides by a Python scalar as a multiply by its reciprocal)."""
    from letf_tpu_torch.ops import compose

    model = default_sim_model()
    rs = np.random.default_rng(6)
    spy = 0.0003 + 0.012 * rs.standard_t(5, (S, B))
    vix = np.clip(20.0 + 8.0 * rs.standard_normal((S, B)), 9.0, 80.0)
    regime = np.cumsum(rs.random((S, B)) < 0.05, 0) % 2
    chans = [torch.as_tensor(c, dtype=torch.float32, device=dev)
             for c in (spy, 1.2 * spy, -0.2 * spy, vix,
                       np.full((S, B), 3.0), regime)]
    args = (tparams.pack_stress_params(model).to(dev),
            tparams.pack_asset_params(model).to(dev),
            (torch.arange(B, device=dev) // 2).to(torch.int32), [9, 11],
            *chans)
    n0 = compose.LAUNCHES
    got = compose.compose_generate(*args)
    assert compose.LAUNCHES == n0 + 1
    ref = compose.compose_plain(*args)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["merge", "valley"])
def test_sort_bridge_kernel_bitwise(dev, kind):
    from letf_tpu_torch.ops import sort_bridge as k7

    g = torch.Generator(device=dev).manual_seed(3)
    R, half = 300, 700
    N = 2 * half
    key = torch.round(torch.randn((N, R), generator=g, device=dev).abs()
                      * 4) / 4
    key[half:] = torch.sort(key[half:], dim=0).values
    if kind == "merge":
        key[:half] = torch.sort(key[:half], dim=0).values
    pos = torch.arange(N, device=dev, dtype=torch.int32)
    sec = torch.where(pos >= half, pos | (1 << 24), pos)[:, None].expand(
        N, R).contiguous()
    pays = tuple(torch.randn((N, R), generator=g, device=dev)
                 for _ in range(4))
    n0 = k7.LAUNCHES
    got = k7.sort_bridge(key, sec, pays, kind=kind)
    assert k7.LAUNCHES == n0 + 1
    for a, b in zip(got, k7.sort_bridge_plain(key, sec, pays)):
        assert torch.equal(a, b)


def test_wash_kernel_bitwise(dev):
    from letf_tpu_torch.ops import wash

    g = torch.Generator(device=dev).manual_seed(4)

    def sparse(p, scale):
        u = torch.rand((S, B), generator=g, device=dev)
        return torch.where(u < p, torch.rand((S, B), generator=g,
                                             device=dev) * scale, 0.0)

    buy, sell = sparse(0.25, 6.0), sparse(0.15, 8.0)
    loss = torch.where(sell > 0, sparse(0.5, 100.0), 0.0)
    n0 = wash.LAUNCHES
    got = wash.wash_matching(loss, sell, buy)
    assert wash.LAUNCHES == n0 + 1
    for a, b in zip(got, wash.wash_plain(loss, sell, buy)):
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


def test_kernel_info_reports_every_kernel(dev):
    """letf_kernel_info: every kernel of the library fits on an SM at its
    launch shape, and K3 keeps more than 4 warps resident an SM."""
    from letf_tpu_torch.ops import _build

    info = _build.kernel_info()
    assert set(info) == set(_build.KERNEL_INFO)
    for name, v in info.items():
        assert v["registers"] > 0 and v["blocks_per_sm"] >= 1, (name, v)
    assert info["compose_strategies"]["warps_per_sm"] > 4, info


def test_gbm_kernel_matches_plain(dev):
    """K6 against its plain version: the same counter bits and float32
    operations (wealth within rtol 1e-5, drawdown within 1e-5), an odd day
    count included."""
    from letf_tpu_torch.ops import gbm

    for days in (252, 63):
        args = (5, 8192, days, 0.0004, 0.015, 3.0, 3e-5)
        n0 = gbm.LAUNCHES
        w, m = gbm.gbm_buyhold(*args, device=dev)
        assert gbm.LAUNCHES == n0 + 1
        wp, mp = gbm.gbm_plain(*args, device=dev)
        torch.testing.assert_close(w, wp, rtol=1e-5, atol=0)
        torch.testing.assert_close(m, mp, rtol=0, atol=1e-5)
