"""The port's sequential-FMA conv order (``ops/fma_gemm.py``,
``models/tflite_import.py::FMA_ORDERS``) against nnstreamer_tpu's
``precision=HIGHEST`` float32 conv on XLA:CPU.

* every listed conv (a conv of the int8 MobileNet-v2 fixture at its
  spatial size, at batch 1, 4 or 64) on seeded inputs: the port's conv,
  in the order ``FMA_ORDERS`` lists for it (one, two or four FMA chains
  over K, or a chain a block of 512), equals the reference's jitted
  ``conv_general_dilated`` bit for bit;
* ``fma_gemm_plain`` is the correctly rounded ``fmaf`` chain (checked
  against exact rational arithmetic, a sum that lands inexactly on a
  float32 midpoint included);
* the full-width fixture's first conv, in the reference's jitted
  fake-quant forward and the port's, gives the same float32 values;
* the first depthwise conv's fake-quant snap (the second conv's input)
  equals the reference's, where XLA multiplies by the scale's float32
  reciprocal;
* the whole fake-quant forward equals the jitted reference's on the
  fixture's 4 frames (0 LSB; ROADMAP §C), the residual ADDs contracted
  as XLA contracts them."""
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import nnstreamer_tpu_torch.models.tflite_import as P  # noqa: E402
from nnstreamer_tpu_torch.ops.fma_gemm import fma_gemm, fma_gemm_plain  # noqa: E402

# (kh, kw, stride_h, stride_w, in_c, out_c) of each listed conv and the
# spatial size of its input in the fixture
_HW = {(3, 3, 2, 2, 3, 32): 224, (1, 1, 1, 1, 32, 192): 28,
       (1, 1, 1, 1, 192, 64): 14, (1, 1, 1, 1, 64, 384): 14,
       (1, 1, 1, 1, 384, 64): 14, (1, 1, 1, 1, 96, 576): 14,
       (1, 1, 1, 1, 160, 960): 7, (1, 1, 1, 1, 320, 1280): 7,
       # two chains
       (1, 1, 1, 1, 16, 96): 112, (1, 1, 1, 1, 144, 32): 28,
       (1, 1, 1, 1, 192, 32): 28, (1, 1, 1, 1, 384, 96): 14,
       (1, 1, 1, 1, 576, 96): 14, (1, 1, 1, 1, 576, 160): 7,
       (1, 1, 1, 1, 960, 160): 7,
       # four chains
       (1, 1, 1, 1, 32, 16): 112, (1, 1, 1, 1, 24, 144): 56,
       (1, 1, 1, 1, 96, 24): 56, (1, 1, 1, 1, 144, 24): 56,
       # one chain a block of 512
       (1, 1, 1, 1, 960, 320): 7}
# the batches each is listed at: at batch 1 XLA sums the 7x7 convs in
# another order
_CASES = [(b, shape) for shape in sorted(_HW) for b in (1, 4, 64)
          if (b, _HW[shape]) != (1, 7)]


def _case_id(case):
    b, shape = case
    name = "x".join(map(str, shape))
    return name if b == 4 else f"{name}-batch{b}"


def _ref_conv(x, w_hwio, strides):
    f = jax.jit(lambda a, b: jax.lax.conv_general_dilated(
        a, b, window_strides=strides, padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST))
    return np.asarray(f(jnp.asarray(x), jnp.asarray(w_hwio)))


def _port_conv(x, w_hwio, strides):
    kh, kw, ic, oc = w_hwio.shape
    xt = torch.from_numpy(x)
    order = P.FMA_ORDERS[(*x.shape[:3], kh, kw, *strides, ic, oc)]
    if kh == kw == 1 and tuple(strides) == (1, 1):
        p = xt
    else:
        p = P.im2col(xt, kh, kw, strides, (1, 1), "SAME", 0.0)
    return fma_gemm(p.contiguous(), torch.from_numpy(w_hwio.reshape(-1, oc)),
                    *order).numpy()


def test_every_listed_shape_has_a_case():
    assert {(b, _HW[s], _HW[s], *s) for b, s in _CASES} == \
        set(P.FMA_ORDERS)


@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_listed_shape_equals_the_reference_conv_bit_for_bit(case):
    batch, shape = case
    kh, kw, sh, sw, ic, oc = shape
    rng = np.random.default_rng(sum(shape) + (batch != 4) * batch)
    x = rng.standard_normal((batch, _HW[shape], _HW[shape], ic)
                            ).astype(np.float32)
    w = (rng.standard_normal((kh, kw, ic, oc)) / np.sqrt(kh * kw * ic)
         ).astype(np.float32)
    want = _ref_conv(x, w, (sh, sw))
    got = _port_conv(x, w, (sh, sw))
    assert got.shape == want.shape
    assert int((got != want).sum()) == 0


def _fmaf(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """float32(a*b + c) rounded once, to nearest even, from exact rationals."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(exact))
    cands = [r, np.nextafter(r, np.float32(np.inf)),
             np.nextafter(r, np.float32(-np.inf))]

    def key(v):
        d = abs(Fraction(float(v)) - exact)
        odd = int(np.asarray(v).view(np.uint32)) & 1
        return (d, odd)
    return min(cands, key=key)


def test_plain_version_is_the_correctly_rounded_fma_chain():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((40, 9)).astype(np.float32)
    b = rng.standard_normal((9, 5)).astype(np.float32)
    # near-cancelling terms, where a separate multiply and add round twice
    a[:8] *= np.float32(1 + 2 ** -20)
    b[:, :2] = np.float32(1 - 2 ** -22)
    # a step whose float64 sum lands on a float32 midpoint but is inexact
    # (9.090940475463867 + -0.4166669547557831 * -0.02209051512181759)
    a[39] = 0
    a[39, :2] = [9.090940475463867, -0.4166669547557831]
    b[:2, 4] = [1.0, -0.02209051512181759]
    got = fma_gemm_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.zeros((40, 5), np.float32)
    for m in range(40):
        for n in range(5):
            acc = np.float32(0)
            for k in range(9):
                acc = _fmaf(a[m, k], b[k, n], acc)
            want[m, n] = acc
    np.testing.assert_array_equal(got, want)
    assert got[39, 4] == np.float32(9.100144386291504)


@pytest.mark.parametrize("chains,kblock", [(2, 0), (4, 0), (1, 512)])
def test_plain_orders_compose_from_single_chains(chains, kblock):
    """Two / four chains are single chains over k ≡ c (mod chains),
    summed pairwise; blocks are single chains over each block of K,
    summed in order."""
    g = torch.Generator().manual_seed(chains + kblock)
    a = torch.randn(37, 1100, generator=g)
    b = torch.randn(1100, 33, generator=g)
    got = fma_gemm_plain(a, b, chains, kblock)
    if kblock:
        parts = [fma_gemm_plain(a[:, k:k + kblock], b[k:k + kblock])
                 for k in range(0, 1100, kblock)]
        want = (parts[0] + parts[1]) + parts[2]
    else:
        parts = [fma_gemm_plain(a[:, c::chains], b[c::chains])
                 for c in range(chains)]
        want = (parts[0] + parts[1] if chains == 2
                else (parts[0] + parts[1]) + (parts[2] + parts[3]))
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        fma_gemm_plain(a, b, 3)
    with pytest.raises(ValueError):
        fma_gemm_plain(a, b, 2, 512)


def test_plain_chains_longer_than_k():
    """Four chains over K = 3: the last chain is empty (zero)."""
    g = torch.Generator().manual_seed(1)
    a, b = torch.randn(5, 3, generator=g), torch.randn(3, 3, generator=g)
    one = [a[:, k:k + 1] * b[k:k + 1] for k in range(3)]
    want = (one[0] + one[1]) + (one[2] + torch.zeros(5, 3))
    assert torch.equal(fma_gemm_plain(a, b, 4), want)


def test_fixture_first_conv_equals_the_jitted_reference():
    import nnstreamer_tpu.models.tflite_import as R
    from pathlib import Path
    model = str(Path(__file__).resolve().parent / "fixtures"
                / "mobilenet_v2_1.0_224_int8.tflite")
    frames = np.random.default_rng(0).integers(
        -128, 128, (4, 224, 224, 3)).astype(np.int8)
    opts = {"quantized_exec": "fake-quant", "batch": "4"}
    rfn, _, _ = R.load_tflite(model, opts)
    pfn, _, _ = P.load_tflite(model, opts, device="cpu")
    orig_r, orig_p = R._fused, P._fused

    def first_conv(x):
        seen = []

        def fused(act, y):
            seen.append(y)
            return orig_r(act, y)
        R._fused = fused
        try:
            rfn(x)
        finally:
            R._fused = orig_r
        return seen[0]
    want = np.asarray(jax.jit(first_conv)(frames))
    seen = []

    def fused_p(act, y):
        if not seen:
            seen.append(y.numpy().copy())
        return orig_p(act, y)
    P._fused = fused_p
    try:
        pfn(torch.from_numpy(frames))
    finally:
        P._fused = orig_p
    np.testing.assert_array_equal(seen[0], want)


def test_fixture_first_snap_equals_the_jitted_reference():
    """Op 1's output snapped to its grid, as the second conv reads it:
    the jitted reference's ``round(y / scale)`` runs as ``y * (1 /
    scale)`` with the reciprocal rounded to float32 (XLA's algebraic
    simplifier), and the port's snap multiplies by the same float32."""
    import nnstreamer_tpu.models.tflite_import as R
    from pathlib import Path
    model = str(Path(__file__).resolve().parent / "fixtures"
                / "mobilenet_v2_1.0_224_int8.tflite")
    frames = np.random.default_rng(0).integers(
        -128, 128, (4, 224, 224, 3)).astype(np.int8)
    opts = {"quantized_exec": "fake-quant", "batch": "4"}
    rfn, _, _ = R.load_tflite(model, opts)
    orig_conv = jax.lax.conv_general_dilated

    def second_conv_input(x):
        seen = []

        def conv(lhs, *a, **k):
            seen.append(lhs)
            return orig_conv(lhs, *a, **k)
        jax.lax.conv_general_dilated = conv
        try:
            rfn(x)
        finally:
            jax.lax.conv_general_dilated = orig_conv
        return seen[1]
    want = np.asarray(jax.jit(second_conv_input)(frames))
    orig_fma = P.fma_gemm
    seen = []

    def recording(a, *args):
        if a.device.type == "cpu":
            seen.append(a.numpy().copy())
        return orig_fma(a, *args)
    P.fma_gemm = recording
    try:
        pfn, _, _ = P.load_tflite(model, opts, device="cpu")
        pfn(torch.from_numpy(frames))
    finally:
        P.fma_gemm = orig_fma
    # ops 0 and 2 are the first two convs (both in FMA_ORDERS): op 2 reads
    # op 1's snap
    np.testing.assert_array_equal(seen[1].reshape(want.shape), want)


def test_full_width_fake_quant_no_further_than_recorded():
    """The fault ROADMAP §C records, closed: on the fixture's 4 frames the
    port's fake-quant equals the jitted reference (0 LSB), with every conv
    in XLA's order (``FMA_ORDERS``, ``tests/test_torch_tflite_dw_fma.py``
    for the depthwise ones), the snaps multiplying by the scale's float32
    reciprocal and the residual ADDs contracted into an FMA."""
    import nnstreamer_tpu.models.tflite_import as R
    from pathlib import Path
    model = str(Path(__file__).resolve().parent / "fixtures"
                / "mobilenet_v2_1.0_224_int8.tflite")
    frames = np.random.default_rng(0).integers(
        -128, 128, (4, 224, 224, 3)).astype(np.int8)
    opts = {"quantized_exec": "fake-quant", "batch": "4"}
    rfn, _, _ = R.load_tflite(model, opts)
    pfn, _, _ = P.load_tflite(model, opts, device="cpu")
    want = np.asarray(jax.jit(rfn)(frames)[0]).astype(np.int64)
    got = pfn(torch.from_numpy(frames))[0].numpy().astype(np.int64)
    assert int(np.abs(got - want).max()) <= 0
    assert int(np.abs(got[:2] - want[:2]).max()) <= 0
