"""The port's measurement utilities against csdr_tpu's on the CPU:
``utils/roofline.account`` (exactly, under the key map of its docstring),
``utils/timing._scalarize`` and ``time_kernel``, and the FP32 probe's plain
version (``kernels/probe_cuda.fma_chain_plain``) against csdr_tpu's jitted
chain (``csdr_tpu/utils/roofline.py:89-93``).  Every ``measure_*`` needs
the card and raises here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csdr_tpu.core.cplx import CF
from csdr_tpu.utils import roofline as jroof
from csdr_tpu.utils import timing as jtiming
from csdr_tpu_torch.kernels import probe_cuda
from csdr_tpu_torch.utils import roofline, timing

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(2)

# csdr_tpu's keys -> the port's (roofline.py's docstring)
KEY_MAP = {"mxu_busy_pct": "matmul_busy_pct", "vpu_busy_pct": "fp32_busy_pct"}
BOUND_MAP = {"mxu": "matmul", "vpu": "fp32", "hbm": "hbm"}

# (seconds, bytes, flops, ideal_flops, elementwise flops), one case a
# binding resource: memory, the matrix unit, the elementwise unit
ACCOUNT_CASES = {
    "hbm": (2.5e-5, 8.1e7, 3.0e8, None, 1.0e8),
    "matmul": (1.0e-3, 1.0e7, 1.4e11, 1.1e11, 2.0e9),
    "fp32": (4.0e-4, 2.0e7, 0.0, None, 9.6e9),
}


def _peaks(precision):
    """The same ceilings in each package's keys."""
    jax_peaks = {"hbm_bw_GBps": 2987.5, f"mxu_{precision.lower()}_Tflops":
                 412.25, "vpu_Tflops": 61.75}
    port = {"hbm_bw_GBps": 2987.5, f"matmul_{precision.lower()}_Tflops":
            412.25, "fp32_Tflops": 61.75}
    return jax_peaks, port


@pytest.mark.parametrize("precision", ["HIGHEST", "HIGH", "DEFAULT", "BF16"])
@pytest.mark.parametrize("bound", sorted(ACCOUNT_CASES))
def test_account_equals_csdr_tpu_under_the_key_map(bound, precision):
    sec, nbytes, flops, ideal, elem = ACCOUNT_CASES[bound]
    jp, tp = _peaks(precision)
    want = jroof.account("k", sec, nbytes, flops, jp, precision, ideal,
                         vpu_flops=elem)
    got = roofline.account("k", sec, nbytes, flops, tp, precision, ideal,
                           fp32_flops=elem)
    assert want["bound_by"] == {"hbm": "hbm", "matmul": "mxu",
                                "fp32": "vpu"}[bound]
    mapped = {KEY_MAP.get(k, k): (BOUND_MAP[v] if k == "bound_by" else v)
              for k, v in want.items()}
    assert got == mapped


def test_account_without_elementwise_work_equals_csdr_tpu():
    jp, tp = _peaks("HIGHEST")
    want = jroof.account("k", 1e-4, 3e8, 2e9, jp)
    got = roofline.account("k", 1e-4, 3e8, 2e9, tp)
    assert got == {KEY_MAP.get(k, k): (BOUND_MAP[v] if k == "bound_by"
                                       else v) for k, v in want.items()}


@pytest.mark.parametrize("bound", sorted(ACCOUNT_CASES))
def test_least_seconds_is_accounts_least_time(bound):
    """least_seconds is account's least time unrounded, with its bound."""
    sec, nbytes, flops, ideal, elem = ACCOUNT_CASES[bound]
    _, tp = _peaks("HIGHEST")
    light, by = roofline.least_seconds(nbytes, tp, ideal or flops,
                                       "HIGHEST", elem)
    acc = roofline.account("k", sec, nbytes, flops, tp, "HIGHEST", ideal,
                           fp32_flops=elem)
    assert by == acc["bound_by"] == bound
    assert round(100.0 * light / sec, 1) == acc["pct_of_roofline"]


# rows of chip_smoke.py's kernel table: (bytes, FP32 flops) of K2 at path
# C's shape, K3 at N=256/B=270, K4 at D=16 and K5 at path P's shape
ROWS = [(8 * (816 + 2_403_000) + 4 * 801 + 8 * 48_060, 4 * 801 * 48_060),
        (16 * 270 * 256, 5 * 270 * 256 * 8),
        (8 * (1024 * 8 * 128 + 64 * 8 * 128 + 128 * 56 + 64 * 56 + 64 * 1024
              + 64 * 1024 * 56), 8 * 1024 * 64 * 8 * 128
         + 8 * 1024 * 64 * 128 * 56),
        (8 * 2_401_030 + 4 * 1023 + 8 * 240_000, 4 * 1023 * 240_000)]


@pytest.mark.parametrize("nbytes,flops", ROWS)
def test_published_bound_is_the_former_constant_formula(nbytes, flops):
    """chip_smoke.py's bound_ms, now from PUBLISHED through least_seconds,
    is bit for bit its former max(bytes / 3.35e12, flops / 67e12)."""
    pub = roofline.published_peaks("NVIDIA H100 80GB HBM3")
    light, by = roofline.least_seconds(nbytes, pub, fp32_flops=flops)
    t_bytes, t_ops = nbytes / 3.35e12 * 1e3, flops / 67e12 * 1e3
    assert light * 1e3 == max(t_bytes, t_ops)
    assert by == ("hbm" if t_bytes >= t_ops else "fp32")


def test_published_peaks():
    pub = roofline.published_peaks("NVIDIA H100 80GB HBM3")
    assert pub["hbm_bw_GBps"] == 3350.0 and pub["fp32_Tflops"] == 67.0
    assert pub["matmul_default_Tflops"] == 495.0
    assert pub["matmul_high_Tflops"] == 495.0 / 3 and \
        pub["matmul_high_derived"]
    assert pub["matmul_bf16_Tflops"] == 989.0 and pub["power_W"] == 700.0
    with pytest.raises(KeyError, match="no published peaks"):
        roofline.published_peaks("NVIDIA A100-SXM4-40GB")


def test_matmul_precision_restores_the_flags():
    cuda = torch.backends.cuda.matmul
    before = (cuda.allow_tf32, cuda.allow_bf16_reduced_precision_reduction)
    with roofline.matmul_precision("DEFAULT"):
        assert cuda.allow_tf32
        assert not cuda.allow_bf16_reduced_precision_reduction
    with roofline.matmul_precision("HIGHEST"):
        assert not cuda.allow_tf32
    assert (cuda.allow_tf32,
            cuda.allow_bf16_reduced_precision_reduction) == before
    with pytest.raises(ValueError):
        with roofline.matmul_precision("TF32"):
            pass


@pytest.mark.parametrize("fn", [
    lambda: roofline.measure_hbm_bw(),
    lambda: roofline.measure_matmul_flops("HIGHEST"),
    lambda: roofline.measure_matmul_flops("HIGH"),
    lambda: roofline.measure_fp32_flops(),
    lambda: roofline.device_peaks()])
def test_measure_raises_without_cuda(monkeypatch, fn):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        fn()


def _pytrees(rng):
    re, im = (rng.standard_normal(4096).astype(np.float32) for _ in (0, 1))
    real = rng.standard_normal((3, 700)).astype(np.float32)
    ints = rng.integers(-30000, 30000, 999).astype(np.int16)
    return [
        (CF(jnp.asarray(re), jnp.asarray(im)),
         torch.from_numpy(re + 1j * im)),
        ((jnp.asarray(real), jnp.asarray(ints)),
         (torch.from_numpy(real), torch.from_numpy(ints))),
        ((CF(jnp.asarray(re), jnp.asarray(im)), jnp.asarray(real)),
         (torch.from_numpy(re + 1j * im), torch.from_numpy(real)))]


def test_scalarize_equals_csdr_tpu():
    """The same sum of every leaf; the two packages add in other orders,
    so they agree to float32 rounding: within 1e-6 of the sum of
    magnitudes."""
    for jy, ty in _pytrees(np.random.default_rng(0)):
        want = float(jtiming._scalarize(jy))
        got = timing._scalarize(ty)
        assert got.dtype == torch.float32 and got.dim() == 0
        scale = sum(float(np.abs(np.asarray(v, np.float64)).sum())
                    for v in jax.tree_util.tree_leaves(jy))
        assert abs(float(got) - want) <= 1e-6 * scale


def test_scalarize_into_writes_each_leafs_sum():
    jy, ty = _pytrees(np.random.default_rng(1))[2]
    row = torch.zeros(2)
    timing._scalarize_into(ty, row)
    assert torch.equal(row.sum(), timing._scalarize(ty))


@pytest.mark.parametrize("chain", [1, 64, 2048])
def test_fma_chain_plain_equals_the_jitted_jax_chain(chain):
    """XLA's CPU backend contracts csdr_tpu's ``y * a + b`` into one fma
    inside jit, as the probe kernel's fmaf: bit for bit."""
    x = np.random.default_rng(chain).standard_normal(1500).astype(np.float32)

    def jchain(y):
        for _ in range(chain):
            y = y * np.float32(1.0000001) + np.float32(1e-7)
        return y

    want = np.asarray(jax.jit(jchain)(jnp.asarray(x)))
    got = probe_cuda.fma_chain_plain(torch.from_numpy(x), chain).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_fma_chain_takes_the_plain_version_on_the_cpu():
    x = torch.from_numpy(
        np.random.default_rng(3).standard_normal(300).astype(np.float32))
    n0 = probe_cuda.LAUNCHES["fma_chain"]
    y = probe_cuda.fma_chain(x, 33, 1.5, -0.25)
    assert torch.equal(y, probe_cuda.fma_chain_plain(x, 33, 1.5, -0.25))
    assert probe_cuda.LAUNCHES["fma_chain"] == n0
    # one link is one fma: exact where the product and sum are
    assert torch.equal(probe_cuda.fma_chain(torch.tensor([2.0]), 1, 3, 1),
                       torch.tensor([7.0]))
    with pytest.raises(TypeError):
        probe_cuda.fma_chain(x.double(), 3)
    with pytest.raises(ValueError):
        probe_cuda.fma_chain(x, -1)


def test_time_kernel_perturb_modes_agree():
    """The counterpart of tests/test_cm_scans.py's: every perturbation
    mode times the same kernel on CPU tensors (the caller's explicit
    request for the CPU), and none changes the caller's input."""
    x = torch.arange(4096, dtype=torch.float32) * (1 + 1j)
    aux = torch.full((4096,), 2.0)
    x0 = x.clone()

    def k(v, a):
        return v.real * a, v.imag + 1.0

    times = {p: timing.time_kernel(k, x, k_pair=(4, 16), aux=aux, perturb=p)
             for p in ("add", "dus", "rotate")}
    assert all(np.isfinite(t) and t > 0 for t in times.values()), times
    assert torch.equal(x, x0)
    with pytest.raises(ValueError, match="perturb"):
        timing.time_kernel(k, x, aux=aux, perturb="copy")


def test_time_kernel_smoke_calls_the_kernel_once(monkeypatch):
    monkeypatch.setenv("CSDR_TIMING_SMOKE", "1")
    calls = []

    def k(v):
        calls.append(v)
        return v * 2

    assert timing.time_kernel(k, torch.ones(8)) == 1.0
    assert len(calls) == 1


def test_time_kernel_escalates_on_the_cpu():
    """Without a k_pair it escalates from (8, 64) and returns a positive
    time per call."""
    t = timing.time_kernel(lambda v: v * 3, torch.ones(1024, dtype=torch.int16),
                           reps=1, target_ms=1.0)
    assert np.isfinite(t) and t > 0
