"""The fastddc channelizer of csdr_tpu_torch against csdr_tpu: the plan and
host arrays bit for bit, and every block streamed chunk by chunk on the
same numpy inputs.  csdr_tpu's Pallas kernels run in interpret mode, as its
own tests run them; the port's wrappers take their plain versions on the
CPU.  The bar between the two, a max error relative to the peak of 5e-5,
is the one csdr_tpu's tests set between its kernel and XLA paths
(tests/test_fastddc.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csdr_tpu.core.cplx import CF
from csdr_tpu.kernels import fastddc_pallas as jfpk
from csdr_tpu.kernels import fft_pallas as jfk
from csdr_tpu.ops import fastddc as jfd

import csdr_tpu_torch
from csdr_tpu_torch.kernels import fft_cuda
from csdr_tpu_torch.ops import fastddc as tfd

torch.set_num_threads(2)

RATES8 = [0.1, -0.23, 0.37, 0.02, -0.07, 0.31, -0.4, 0.18]
REL_BAR = 5e-5


def _cf(x):
    return CF(jnp.asarray(np.ascontiguousarray(x.real, np.float32)),
              jnp.asarray(np.ascontiguousarray(x.imag, np.float32)))


def _np(a):
    if isinstance(a, CF):
        return np.asarray(a.re) + 1j * np.asarray(a.im)
    return np.asarray(a)


def _noise(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(ref, got):
    return np.abs(ref - got).max() / np.abs(ref).max()


def _stream(jblk, tblk, chunks, jstate=None):
    """Both packages over the same chunks; per chunk, the valid outputs
    (C, count) of each and the counts.  Returns the carried states too."""
    sj = jblk.init() if jstate is None else jstate
    st = tblk.init("cpu")
    outs = []
    for x in chunks:
        sj, oj = jblk.apply(sj, _cf(x))
        with torch.no_grad():
            st, ot = tblk(st, torch.from_numpy(x))
        cj = np.asarray(oj.count)
        assert np.all(cj == cj[0]) and int(cj[0]) == ot.count
        assert tuple(ot.data.shape) == tuple(np.asarray(oj.data.re).shape)
        outs.append((_np(oj.data)[:, : ot.count], ot.compact().numpy()))
    return outs, sj, st


# --------------------------------------------------------------------------
# plan and host arrays: exactly equal
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d,rate", [(8, 0.1), (4, -0.2), (20, 0.05),
                                    (1, 0.0), (50, 0.2), (64, -0.3)])
def test_fastddc_init_fields_equal(d, rate):
    assert dataclasses.asdict(tfd.fastddc_init(0.05, d, rate)) == \
        dataclasses.asdict(jfd.fastddc_init(0.05, d, rate))


@pytest.mark.parametrize("n", [128, 256, 1024, 2048, 16384])
def test_kernel_perm_equal(n):
    assert np.array_equal(fft_cuda.kernel_perm(n), jfk.kernel_perm(n))
    assert np.array_equal(tfd._ko_gather_idx(n), jfd._ko_gather_idx(n))


@pytest.mark.parametrize("d", [4, 16, 256])
def test_factored_host_arrays_equal(d):
    rates = [0.11, -0.2, 0.37]
    jd, td = jfd.fastddc_init(0.05, d), tfd.fastddc_init(0.05, d)
    for r in rates:
        assert np.array_equal(
            tfd.make_fold_perm(tfd.fastddc_init(0.05, d, r)),
            jfd.make_fold_perm(jfd.fastddc_init(0.05, d, r)))
    for a, b in zip(tfd.channel_factored2_arrays(td, rates),
                    jfd.channel_factored2_arrays(jd, rates)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(tfd.channelizer_arrays(td, rates),
                    jfd.channelizer_arrays(jd, rates)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tfd.mpad_for(td) == jfd.mpad_for(jd)
    g1, c1 = tfd.channel_fused_matrix(td, rates[0])
    g2, c2 = jfd.channel_fused_matrix(jd, rates[0])
    assert np.array_equal(g1, g2) and c1 == c2


@pytest.mark.parametrize("d", [20, 50])
def test_class_host_arrays_equal(d):
    jd, td = jfd.fastddc_init(0.05, d), tfd.fastddc_init(0.05, d)
    for a, b in zip(tfd._class_plan(td), jfd._class_plan(jd)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    g1, dsa1 = tfd.channel_class_matrices(td, -0.23)
    g2, dsa2 = jfd.channel_class_matrices(jd, -0.23)
    assert g1.dtype == g2.dtype and np.array_equal(g1, g2) and dsa1 == dsa2


# --------------------------------------------------------------------------
# blocks, streamed
# --------------------------------------------------------------------------

def test_channelizer_matches_jax(monkeypatch):
    """D=16, 8 channels: a chunk of 128 frames (csdr_tpu's Pallas kernel,
    interpreted) then 48 (its XLA fallback); the port's K4 plain path both
    times.  Counts equal, carried phases within 1e-6."""
    monkeypatch.setenv("CSDR_PALLAS_INTERPRET", "1")
    ddc = tfd.fastddc_init(0.05, 16)
    assert jfpk.pick_tiles(128, 8, ddc.pre_decimation,
                           ddc.fft_inv_size) is not None
    assert jfpk.pick_tiles(48, 8) is None
    rng = np.random.default_rng(4)
    chunks = [_noise(rng, b * ddc.input_size) for b in (128, 48)]
    jblk = jfd.fastddc_channelizer_block(jfd.fastddc_init(0.05, 16), RATES8,
                                         precision="HIGHEST")
    tblk = tfd.fastddc_channelizer_block(ddc, RATES8)
    outs, sj, st = _stream(jblk, tblk, chunks)
    for ref, got in outs:
        assert _rel(ref, got) < REL_BAR
    np.testing.assert_allclose(st[1].numpy(), np.asarray(sj[1]), atol=1e-6)
    np.testing.assert_array_equal(st[0].numpy(), _np(sj[0]))


def test_fwd_inv_natural_d16_matches_jax():
    """fastddc_fwd_block | fastddc_inv_block at D=16 (the port's inverse is
    the factored-v2 K4 block; csdr_tpu's off-TPU choice the fused matrix),
    two chunks of 40 frames."""
    ddc = tfd.fastddc_init(0.05, 16)
    jddc = jfd.fastddc_init(0.05, 16)
    assert isinstance(tfd.fastddc_inv_block(ddc, RATES8),
                      tfd.FastddcInvFactored2Block)
    rng = np.random.default_rng(5)
    chunks = [_noise(rng, 40 * ddc.input_size) for _ in range(2)]
    jf, tf = jfd.fastddc_fwd_block(jddc), tfd.fastddc_fwd_block(ddc)
    ji, ti = jfd.fastddc_inv_block(jddc, RATES8), \
        tfd.fastddc_inv_block(ddc, RATES8)
    sjf, sji, stf, sti = jf.init(), ji.init(), tf.init("cpu"), ti.init("cpu")
    for x in chunks:
        sjf, spj = jf.apply(sjf, _cf(x))
        sji, oj = ji.apply(sji, spj)
        with torch.no_grad():
            stf, spt = tf(stf, torch.from_numpy(x))
            sti, ot = ti(sti, spt)
        assert _rel(_np(spj), spt.numpy()) < 1e-5
        assert int(np.asarray(oj.count)[0]) == ot.count
        assert _rel(_np(oj.data), ot.data.numpy()) < REL_BAR
    np.testing.assert_allclose(sti.numpy(), np.asarray(sji[0]), atol=1e-6)


def test_fwd_inv_classed_kernel_order_d50_matches_jax():
    """D=50 (phase-classed inverse) with kernel-order spectra: K3's bin
    order folded into the class matrices, 2q frames over two chunks."""
    ddc = tfd.fastddc_init(0.05, 50)
    jddc = jfd.fastddc_init(0.05, 50)
    rates = [0.1, -0.23, 0.31, -0.4]
    q = tfd._class_plan(ddc)[0]
    rng = np.random.default_rng(9)
    chunks = [_noise(rng, q * ddc.input_size) for _ in range(2)]
    jf = jfd.fastddc_fwd_block(jddc, spectra_order="kernel")
    ji = jfd.fastddc_inv_block(jddc, rates, spectra_order="kernel")
    tf = tfd.fastddc_fwd_block(ddc, spectra_order="kernel")
    ti = tfd.fastddc_inv_block(ddc, rates, spectra_order="kernel")
    sjf, sji, stf, sti = jf.init(), ji.init(), tf.init("cpu"), ti.init("cpu")
    for x in chunks:
        sjf, spj = jf.apply(sjf, _cf(x))
        sji, oj = ji.apply(sji, spj)
        with torch.no_grad():
            stf, spt = tf(stf, torch.from_numpy(x))
            sti, ot = ti(sti, spt)
        assert _rel(_np(spj), spt.numpy()) < 1e-5
        assert int(np.asarray(oj.count)[0]) == ot.count
        ref = _np(oj.data)[:, : ot.count]
        assert _rel(ref, ot.compact().numpy()) < REL_BAR
    np.testing.assert_allclose(sti.numpy(), np.asarray(sji[0]), atol=1e-6)


@pytest.mark.parametrize("d", [4, 16, 256])
def test_k4_block_matches_fused_reference(d):
    """The K4 block (fold, shared iDFT, diagonal, per-frame NCO) against
    csdr_tpu's off-TPU route ported as the fused block (one spectra @ G
    product, then the NCO) on the same spectra, two chunks so the carried
    phases count too."""
    ddc = tfd.fastddc_init(0.05, d)
    rates = [0.11, -0.2, 0.3, -0.37]
    k4 = tfd.fastddc_inv_block(ddc, rates)
    fused = tfd._fastddc_inv_fused_block(ddc, rates)
    assert isinstance(k4, tfd.FastddcInvFactored2Block)
    assert isinstance(fused, tfd.FastddcInvFusedBlock)
    rng = np.random.default_rng(20 + d)
    sk, sf = k4.init("cpu"), fused.init("cpu")
    for b in (11, 6):
        sp = torch.from_numpy(_noise(rng, b, ddc.fft_size))
        with torch.no_grad():
            sk, ok = k4(sk, sp)
            sf, of = fused(sf, sp)
        assert ok.count == of.count == b * k4.m
        assert _rel(of.compact().numpy(), ok.compact().numpy()) < REL_BAR
        np.testing.assert_allclose(sk.numpy(), sf.numpy(), atol=1e-6)


@pytest.mark.parametrize("d", [4, 256])
def test_odd_plans_match_jax(d):
    """D=4 (pre=2, M=224) and D=256 (inv=16): plans csdr_tpu routes around
    its kernel; the port's K4 takes them.  The channelizer and fwd | inv,
    two chunks each."""
    ddc, jddc = tfd.fastddc_init(0.05, d), jfd.fastddc_init(0.05, d)
    rates = [0.11, -0.2, 0.3]
    rng = np.random.default_rng(d)
    chunks = [_noise(rng, b * ddc.input_size) for b in (12, 5)]
    outs, sj, st = _stream(
        jfd.fastddc_channelizer_block(jddc, rates, precision="HIGHEST"),
        tfd.fastddc_channelizer_block(ddc, rates), chunks)
    for ref, got in outs:
        assert _rel(ref, got) < REL_BAR
    np.testing.assert_allclose(st[1].numpy(), np.asarray(sj[1]), atol=1e-6)
    ji, ti = jfd.fastddc_inv_block(jddc, rates), \
        tfd.fastddc_inv_block(ddc, rates)
    sji, sti = ji.init(), ti.init("cpu")
    for b in (7, 3):
        sp = _noise(rng, b, ddc.fft_size)
        sji, oj = ji.apply(sji, _cf(sp))
        with torch.no_grad():
            sti, ot = ti(sti, torch.from_numpy(sp))
        assert _rel(_np(oj.data), ot.data.numpy()) < REL_BAR


# --------------------------------------------------------------------------
# csdr_tpu state carried into the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["HIGHEST", "HIGH"])
def test_channelizer_state_from_jax_leaves(precision):
    """csdr_tpu runs chunk 1; its state leaves (tail, phases and the matrix
    leaves, bf16 W at "HIGH") go into the port, which runs chunk 2 like
    csdr_tpu."""
    import jax
    ddc, jddc = tfd.fastddc_init(0.05, 16), jfd.fastddc_init(0.05, 16)
    rates = RATES8[:4]
    rng = np.random.default_rng(11)
    x1, x2 = (_noise(rng, 24 * ddc.input_size) for _ in range(2))
    jblk = jfd.fastddc_channelizer_block(jddc, rates, precision=precision)
    sj, _ = jblk.apply(jblk.init(), _cf(x1))
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(sj)]
    tblk = tfd.fastddc_channelizer_block(ddc, rates)
    st = csdr_tpu_torch.state_from_jax_leaves(tblk, leaves, device="cpu")
    assert st[1].dtype == torch.float32 and st[0].dtype == torch.complex64
    # next chunk against csdr_tpu at HIGHEST from the same state
    jref = jfd.fastddc_channelizer_block(jddc, rates, precision="HIGHEST")
    sref, _ = jref.apply(jref.init(), _cf(x1))
    _, oj = jref.apply(sref, _cf(x2))
    with torch.no_grad():
        _, ot = tblk(st, torch.from_numpy(x2))
    assert _rel(_np(oj.data), ot.data.numpy()) < REL_BAR


def test_state_from_jax_leaves_checks_matrices_and_shapes():
    import jax
    ddc, jddc = tfd.fastddc_init(0.05, 16), jfd.fastddc_init(0.05, 16)
    ji = jfd._fastddc_inv_vmem_block(jddc, [0.1, -0.2], precision="HIGHEST")
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(ji.init())]
    ok = tfd.fastddc_inv_block(ddc, [0.1, -0.2])
    assert csdr_tpu_torch.state_from_jax_leaves(
        ok, leaves, device="cpu").shape == (2,)
    with pytest.raises(ValueError, match="differs"):          # other rates
        csdr_tpu_torch.state_from_jax_leaves(
            tfd.fastddc_inv_block(ddc, [0.1, -0.3]), leaves, device="cpu")
    with pytest.raises(ValueError, match="shape"):            # 3 channels
        csdr_tpu_torch.state_from_jax_leaves(
            tfd.fastddc_inv_block(ddc, [0.1, -0.2, 0.3]), leaves,
            device="cpu")
    with pytest.raises(ValueError, match="leaves for a state"):
        csdr_tpu_torch.state_from_jax_leaves(ok, leaves + [leaves[0]],
                                             device="cpu")
    # the classed inverse and the forward block
    j50, t50 = jfd.fastddc_init(0.05, 50), tfd.fastddc_init(0.05, 50)
    jc = jfd.fastddc_inv_block(j50, [0.2], spectra_order="kernel")
    lc = [np.asarray(a) for a in jax.tree_util.tree_leaves(jc.init())]
    csdr_tpu_torch.state_from_jax_leaves(
        tfd.fastddc_inv_block(t50, [0.2], spectra_order="kernel"), lc,
        device="cpu")
    with pytest.raises(ValueError, match="differs"):          # other order
        csdr_tpu_torch.state_from_jax_leaves(
            tfd.fastddc_inv_block(t50, [0.2]), lc, device="cpu")
    lf = [np.asarray(a) for a in jax.tree_util.tree_leaves(
        jfd.fastddc_fwd_block(jddc).init())]
    tail = csdr_tpu_torch.state_from_jax_leaves(
        tfd.fastddc_fwd_block(ddc), lf, device="cpu")
    assert tail.shape == (ddc.overlap_length,)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_fastddc_entry_points_raise_without_cuda(no_cuda):
    ddc = tfd.fastddc_init(0.05, 16)
    for blk in (tfd.fastddc_channelizer_block(ddc, [0.1]),
                tfd.fastddc_fwd_block(ddc),
                tfd.fastddc_inv_block(ddc, [0.1]),
                tfd.fastddc_inv_block(tfd.fastddc_init(0.05, 50), [0.1])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            blk.init()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        csdr_tpu_torch.state_from_jax_leaves(tfd.fastddc_fwd_block(ddc), [])
