"""The samplers' kernel (``csrc/draws.cu``) against their torch twin on
the card: ``rng.normal``, ``gamma`` and ``t`` on CUDA keys launch the
kernel, ``rng._normal_plain``, ``_gamma_plain`` and ``_t_plain`` run the
twin on the same keys, and the two agree bit for bit in float32 and
float64; so does a whole parametric ``generate_paths_batch``. Marked
``cuda``; without a card every test skips (decided inside the fixture).
Nothing here needs JAX. On a GPU machine:
``python -m pytest -m cuda --noconftest tests/test_torch_draws_cuda.py``."""

import pytest
import torch

from letf_tpu_torch import config as cfg
from letf_tpu_torch.models import params as tparams
from letf_tpu_torch.models.params import default_sim_model
from letf_tpu_torch.ops import _build, rng
from letf_tpu_torch.ops import path_engine as pe
from letf_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.float64]
BITS = {torch.float32: torch.int32, torch.float64: torch.int64}
# gamma's alphas: the boost (alpha < 1), 1, and every alpha the engine
# draws (each regime's nu / 2, the tracking-error dfs / 2).
ALPHAS = [0.4, 1.0, 2.0, 2.5, 5.0]
DFS = [3.0, 4.0, 5.0, 10.0]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def keys(dev, B, seed):
    return rng.split(rng.key(seed, dev), B)


def bitwise(a, b, finite=True):
    assert a.dtype == b.dtype and a.shape == b.shape and a.is_cuda
    diff = a.view(BITS[a.dtype]) != b.view(BITS[b.dtype])
    assert not diff.any(), (int(diff.sum()), a[diff][:4].tolist(),
                            b[diff][:4].tolist())
    assert not finite or torch.isfinite(a).all()


def launched(fn):
    n0 = rng.LAUNCHES
    out = fn()
    assert rng.LAUNCHES == n0 + 1
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 7, 4096])
@pytest.mark.parametrize("n", [1, 3, 1000, 11340])
@pytest.mark.parametrize("lo", [0, 123457])
def test_normal_kernel_is_the_twin(dev, dtype, B, n, lo):
    k = keys(dev, B, 3 + B)
    got = launched(lambda: rng.normal(k, n, dtype, lo=lo))
    bitwise(got, rng._normal_plain(k, n, dtype, lo=lo))


def test_normal_kernel_takes_any_key_layout(dev):
    """Keys with leading dims and keys that are a strided view."""
    k = rng.split(rng.key(9, dev), 15).reshape(3, 5, 2)
    bitwise(rng.normal(k, 33), rng._normal_plain(k, 33))
    ks = rng.split(keys(dev, 64, 4), 3)[:, 1]
    assert not ks.is_contiguous()
    bitwise(rng.normal(ks, 500, torch.float64),
            rng._normal_plain(ks, 500, torch.float64))


def test_the_cases_cover_the_engine():
    nus = default_sim_model().joint.nu.tolist()
    te = cfg.asset_table().te_df.tolist()
    assert {v / 2 for v in nus + te} <= set(ALPHAS)
    assert set(te) <= set(DFS) and float(cfg.STUDENT_T_DF) in DFS


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("alpha", ALPHAS)
def test_gamma_kernel_is_the_twin(dev, dtype, alpha):
    k = keys(dev, 256, 5)
    got = launched(lambda: rng.gamma(k, alpha, 4096, dtype))
    bitwise(got, rng._gamma_plain(k, alpha, 4096, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("df", DFS)
def test_t_kernel_is_the_twin(dev, dtype, df):
    k = keys(dev, 256, 8)
    got = launched(lambda: rng.t(k, df, 4096, dtype))
    bitwise(got, rng._t_plain(k, df, 4096, dtype))
    k = keys(dev, 16, 1)
    bitwise(rng.t(k, df, 11340, dtype), rng._t_plain(k, df, 11340, dtype))


def test_kernel_refuses_what_it_cannot_draw(dev):
    k = keys(dev, 4, 0)
    with pytest.raises(TypeError):
        rng.normal(k, 8, torch.float16)
    with pytest.raises(TypeError):
        rng.t(k.to(torch.int32), 5.0, 8)
    assert rng.gamma(k, 2.5, 0).shape == (4, 0)


def test_kernel_calls_count_no_syncs_and_no_rounds(dev):
    """Traced, a kernel call counts its draws as ``fused_draws``, adds 0
    ``draw_rounds`` and makes no host-device synchronisation; the twin on
    the same keys rounds and syncs."""
    k = keys(dev, 512, 2)
    rng.gamma(k, 2.5, 64)
    torch.cuda.synchronize()
    profiling.reset()
    with profiling.tracing():
        with profiling.span("kernel"):
            rng.normal(k, 100)
            rng.gamma(k, 2.5, 64)
            rng.t(k, 5.0, 64, torch.float64)
        with profiling.span("twin"):
            rng._t_plain(k, 5.0, 64)
    kern, twin = profiling.records()
    profiling.reset()
    assert kern.counters == {"fused_draws": 512 * (100 + 64 + 64),
                             "draw_rounds": 0}
    assert twin.counters["draw_rounds"] > 0 and twin.counters["syncs"] > 0


def test_kernel_info_of_the_samplers(dev):
    """No local memory (the coefficient tables stay immediates) and at
    least two blocks of 8 warps resident an SM."""
    info = _build.kernel_info()
    for name in ("draws_normal", "draws_gamma", "draws_t"):
        assert info[name]["local_bytes"] == 0, info[name]
        assert info[name]["warps_per_sm"] >= 16, info[name]


def test_a_parametric_path_batch_is_the_twins(dev, monkeypatch):
    """1,024 trials x 10 years in the parametric mode: every field of
    ``generate_paths_batch`` bitwise the same through the kernel and
    through the twin."""
    mt = tparams.from_numpy(default_sim_model(), dev, torch.float32)
    rows = torch.arange(1024, device=dev)
    args = (mt, rng.key(2, dev), rows // 2, rows % 2 == 1, 2520,
            cfg.RANDOM_START_BUFFER_YEARS * 252)
    n0 = rng.LAUNCHES
    got = pe.generate_paths_batch(*args, engine_mode="parametric")
    assert rng.LAUNCHES > n0
    monkeypatch.setattr(rng, "normal", rng._normal_plain)
    monkeypatch.setattr(rng, "gamma", rng._gamma_plain)
    monkeypatch.setattr(rng, "t", rng._t_plain)
    n1 = rng.LAUNCHES
    ref = pe.generate_paths_batch(*args, engine_mode="parametric")
    assert rng.LAUNCHES == n1
    for name, a, b in zip(got._fields, got, ref):
        if a.is_floating_point():
            bitwise(a, b, finite=False)
        else:
            assert torch.equal(a, b), name
