"""The natural-order forward FFT (``fft_cuda.fft_natural``; the NAT form of
``csrc/fft_ko.cu``): a numpy model of its last pass's store, and the
port's kernel-order forward put in natural order by that model against
csdr_tpu's ``fft_pallas.fft_natural`` run in interpret mode (as csdr_tpu's
own tests run it), and the file of csdr_tpu's spectra that the card test
reads (tests/torch_fft_golden.py).

The model follows the kernel's threads over the plan that
``fft_cuda.radix_plan`` gives: after the last pass, group q of thread t of
frame fl holds the 16 bins kb + j*N/16, kb the bin at in-place position
16*(t + q*TPF); it writes bin a to shared slot fl*FRAME + nat_slot(a);
after a barrier, thread t copies pair m = t + i*TPF (points 2m, 2m+1)
from slots nat_slot(2m) and nat_slot(2m) ^ 1 to float4 m of its frame.
It asserts, at every N and every frames_per_block the launch can pick,
that the scatter is a bijection onto the frame's N slots, that the copy
puts bin k at natural position k, which is the kernel-order position
``ko_pos(kb) + 8j`` read through ``kernel_perm``, and that no half-warp's
scatter or copy load hits a bank pair twice (the kernel's comment says
no conflict).  Mutation: the model with the bin stride j*N/16 replaced by
j*N/32 fails the bijection and the order assertions
(``test_natural_store_model_catches_a_wrong_bin_stride``).
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csdr_tpu.core.cplx import CF
from csdr_tpu.kernels import fft_pallas as jfk

from csdr_tpu_torch.kernels import fft_cuda
import torch_fft_golden as golden  # tests/, on the path under pytest

torch.set_num_threads(2)

NS = [1 << k for k in range(7, 15)]
K3_BAR = 110.0          # dB, K3's bar against its plain version
NAT_SWIZZLE = (5, 2, 9, 4, 2, 8)    # csrc/fft_ko.cu's kNatSwizzle, by row bit


def nat_slot(a):
    """csrc/fft_ko.cu's nat_slot: where the natural-order forward puts
    natural bin ``a`` (an int or an integer array) in its frame's shared
    buffer; row bit b of ``a >> 4`` flips the bank pair, ``a``'s low 4
    bits, by NAT_SWIZZLE[b]."""
    h = 0
    for b, flip in enumerate(NAT_SWIZZLE):
        h = h ^ (((a >> (4 + b)) & 1) * flip)
    return a ^ h


def _shape(n):
    """(E, TPF, G, FRAME) as csrc/fft_ko.cu's Shape<LOGN>."""
    e = 32 if n > 8192 else 16
    return e, n // e, e // 16, n + n // 8


def _bin_of(n, p):
    """csrc/fft_ko.cu's bin_of: digit i of in-place position p (at stride
    S_i) is k_i, whose weight in the bin is W_i."""
    plan = fft_cuda.radix_plan(n)
    rb = [r.bit_length() - 1 for r in plan]
    logn = n.bit_length() - 1
    k, before = 0, 0
    for i, r in enumerate(plan):
        sb = logn - before - rb[i]
        k |= ((p >> sb) & (r - 1)) << before
        before += rb[i]
    return k


def _ko_pos(n, k):
    logt = n.bit_length() - 8
    return (fft_cuda._bitrev(k % (1 << logt), logt) << 7) | (k >> logt)


def _fpbs(n):
    """Every frames_per_block the launch can pick at N: powers of two up
    to 64 threads a block."""
    tpf = _shape(n)[1]
    most = max(1, 64 // tpf)
    return [1 << i for i in range(most.bit_length())]


def _model(n, fpb, stride=None):
    """The store of one block of ``fpb`` frames: (scatter, copy), where
    scatter[(q, j)] lists, over the block's threads, (thread, shared slot,
    bin, frame) of one store instruction, and copy[(i, half)] (thread,
    shared slot, natural position, frame) of each of the copy's two
    loads."""
    e, tpf, g, frame = _shape(n)
    stride = n // 16 if stride is None else stride
    scatter, copy = {}, {}
    for tid in range(fpb * tpf):
        fl, t = divmod(tid, tpf)
        for q in range(g):
            kb = _bin_of(n, (t + q * tpf) << 4)
            for j in range(16):
                a = kb + j * stride
                slot = fl * frame + int(nat_slot(a))
                scatter.setdefault((q, j), []).append((tid, slot, a, fl))
        p0 = int(nat_slot(2 * t))
        for i in range(e // 2):
            p = p0 ^ int(nat_slot(2 * i * tpf))
            m = t + i * tpf
            for half, sp in enumerate((p, p ^ 1)):
                copy.setdefault((i, half), []).append(
                    (tid, fl * frame + sp, 2 * m + half, fl))
    return scatter, copy


def _worst_ways(accesses):
    """Most distinct float2 slots one bank pair gets from one half-warp
    (16 lanes of 8 B: 128 B, one pass over the 32 banks)."""
    worst = 0
    for h in range(0, max(a[0] for a in accesses) + 1, 16):
        slots = {a[1] for a in accesses if h <= a[0] < h + 16}
        worst = max(worst, max(Counter(s % 16 for s in slots).values()))
    return worst


def _check_store(n, fpb, stride=None):
    """The model's assertions; returns the worst bank conflict."""
    e, tpf, g, frame = _shape(n)
    scatter, copy = _model(n, fpb, stride)
    worst = 0
    held = {}
    for acc in scatter.values():
        worst = max(worst, _worst_ways(acc))
        for tid, slot, a, fl in acc:
            assert 0 <= slot - fl * frame < n, "a slot outside the frame"
            assert (fl, slot) not in held, f"slot {slot} written twice"
            held[(fl, slot)] = a
    assert len(held) == fpb * n, "the scatter misses slots"
    for acc in copy.values():
        worst = max(worst, _worst_ways(acc))
        for tid, slot, pos, fl in acc:
            a = held[(fl, slot)]
            assert a == pos, f"bin {a} copied to natural position {pos}"
    # the copy covers each frame's N positions once
    got = Counter((a[3], a[2]) for acc in copy.values() for a in acc)
    assert len(got) == fpb * n and set(got.values()) == {1}
    # the kernel-order store of the same registers: bin kb + j*N/16 at
    # ko_pos(kb) + 8j, which kernel_perm maps back to the natural position
    perm = fft_cuda.kernel_perm(n)
    for tid, slot, a, fl in scatter[(0, 1)] + scatter[(g - 1, 15)]:
        kb, j = a % (n // 16), a // (n // 16)
        assert perm[a] == _ko_pos(n, kb) + 8 * j
    return worst


@pytest.mark.parametrize("n", NS[1:])
def test_natural_store_is_a_conflict_free_bijection(n):
    for fpb in _fpbs(n):
        assert _check_store(n, fpb) == 1, f"N={n}, {fpb} frames a block"


def test_natural_store_at_128_is_the_kernel_order_store():
    """At N=128 kernel order is natural order: the kernel keeps K3's own
    store, bin kb + 8j at ko_pos(kb) + 8j, which is the bin itself."""
    perm = fft_cuda.kernel_perm(128)
    assert np.array_equal(perm, np.arange(128))
    for t in range(_shape(128)[1]):
        kb = _bin_of(128, t << 4)
        assert all(_ko_pos(128, kb) + 8 * j == kb + 8 * j for j in range(16))


@pytest.mark.parametrize("n", [512, 4096, 16384])
def test_natural_store_model_catches_a_wrong_bin_stride(n):
    with pytest.raises(AssertionError):
        _check_store(n, 1, stride=n // 32)


@pytest.mark.parametrize("n,ways", [(256, 1), (512, 2), (1024, 1),
                                    (2048, 1), (4096, 2), (8192, 8),
                                    (16384, 8)])
def test_the_passes_pad_would_conflict_on_the_scatter(n, ways):
    """Why the buffer is swizzled: laid out by the passes' pad (two points
    every sixteen), the scatter conflicts 2-way at N = 512 and 4096 and
    8-way at 8192 and 16384 (csrc/fft_ko.cu's comment)."""
    scatter, _ = _model(n, 1)
    pad = [[(tid, a + 2 * (a >> 4)) for tid, _, a, _ in acc]
           for acc in scatter.values()]
    assert max(_worst_ways(acc) for acc in pad) == ways


def test_nat_slot_is_linear_and_a_permutation():
    a = np.arange(16384)
    s = nat_slot(a)
    assert np.array_equal(np.sort(s), a)
    rng = np.random.default_rng(0)
    x, y = rng.integers(0, 16384, 200), rng.integers(0, 16384, 200)
    assert np.array_equal(nat_slot(x ^ y),
                          nat_slot(x) ^ nat_slot(y))


def _snr_db(ref, test):
    err = np.sum(np.abs(ref - test) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(np.abs(ref) ** 2)
                                                 / err)


def _store_values(ko, n):
    """The natural-order store on values: ``ko`` is a frame in kernel order
    (K3's store, bin kb + j*N/16 at ko_pos(kb) + 8j), from which the model's
    threads take the bins they hold after the last pass, scatter them to
    their shared slots and copy the frame out.  At N=128 the kernel keeps
    K3's store."""
    if n == 128:
        return ko.copy()
    scatter, copy = _model(n, 1)
    shared = np.zeros(n, ko.dtype)
    for acc in scatter.values():
        for _, slot, a, _ in acc:
            kb, j = a % (n // 16), a // (n // 16)
            shared[slot] = ko[_ko_pos(n, kb) + 8 * j]
    out = np.empty(n, ko.dtype)
    for acc in copy.values():
        for _, slot, pos, _ in acc:
            out[pos] = shared[slot]
    return out


def _csdr_tpu_natural(x):
    """csdr_tpu's fft_natural (K3's pallas_call in interpret mode, then
    ko_to_natural) at HIGHEST: the port computes in f32 for both of its
    precisions, and HIGH's bf16x3 products read ~108 dB here."""
    ref = jfk.fft_natural(CF(jnp.asarray(x.real), jnp.asarray(x.imag)),
                          precision="HIGHEST")
    return np.asarray(ref.re) + 1j * np.asarray(ref.im)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [128, 1024, 4096])
def test_fft_natural_matches_csdr_tpu_interpret(monkeypatch, n, b):
    """The port's kernel-order forward (fft_ko; on the CPU its plain
    version) put in natural order by the model of the natural-order store,
    against csdr_tpu's fft_natural in interpret mode on the same numpy
    frames, at K3's bar; the port's fft_natural (torch.fft.fft on the CPU)
    is the model's result bit for bit."""
    monkeypatch.setenv("CSDR_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(n + b)
    x = (rng.standard_normal((b, n))
         + 1j * rng.standard_normal((b, n))).astype(np.complex64)
    ko = fft_cuda.fft_ko(torch.from_numpy(x)).numpy()
    got = np.stack([_store_values(f, n) for f in ko])
    ref = _csdr_tpu_natural(x)
    assert got.shape == ref.shape == (b, n)
    assert _snr_db(ref, got) > K3_BAR
    assert np.array_equal(got,
                          fft_cuda.fft_natural(torch.from_numpy(x)).numpy())


def test_fft_natural_golden_is_csdr_tpu_interpret(monkeypatch):
    """tests/data/fft_natural_4096.npz, which the card test
    test_cuda_fft_natural_matches_csdr_tpu_golden reads without JAX: its
    frame is the seeded one and its spectrum is csdr_tpu's (to the
    interpreter's rounding); csdr_tpu on the 37 frames the maps of
    tests/torch_fft_golden.py make agrees with the file's spectrum mapped
    the same way, as does the port's fft_natural."""
    monkeypatch.setenv("CSDR_PALLAS_INTERPRET", "1")
    x, y = golden.load()
    assert x.dtype == y.dtype == np.complex64 and x.shape == (1, 4096)
    assert np.array_equal(x, golden.golden_input())
    assert _snr_db(_csdr_tpu_natural(x), y) > 140
    fx, fy = golden.frames(x, 37), golden.spectra(y, 37)
    assert len({f.tobytes() for f in fx}) == 37
    ref = _csdr_tpu_natural(fx)
    assert min(_snr_db(r, g) for r, g in zip(ref, fy)) > 120
    got = fft_cuda.fft_natural(torch.from_numpy(fx)).numpy()
    assert min(_snr_db(g, f) for g, f in zip(got, fy)) > K3_BAR


if __name__ == "__main__":
    import os
    os.environ["CSDR_PALLAS_INTERPRET"] = "1"
    x0 = golden.golden_input()
    golden.GOLDEN.parent.mkdir(exist_ok=True)
    np.savez(golden.GOLDEN, x=x0,
             y=_csdr_tpu_natural(x0).astype(np.complex64))
