"""The port's sequential-FMA conv order (``ops/fma_gemm.py``,
``models/tflite_import.py::FMA_ORDER_SHAPES``) against nnstreamer_tpu's
``precision=HIGHEST`` float32 conv on XLA:CPU.

* every listed conv (a conv of the int8 MobileNet-v2 fixture at its
  spatial size, at batch 1, 4 or 64) on seeded inputs: the port's conv
  equals the reference's jitted ``conv_general_dilated`` bit for bit;
* ``fma_gemm_plain`` is the correctly rounded ``fmaf`` chain (checked
  against exact rational arithmetic, a sum that lands inexactly on a
  float32 midpoint included);
* the full-width fixture's first conv, in the reference's jitted
  fake-quant forward and the port's, gives the same float32 values;
* the whole fake-quant forward stays within the 5 LSB that ROADMAP §C
  records for the open fault."""
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
       (1, 1, 1, 1, 160, 960): 7, (1, 1, 1, 1, 320, 1280): 7}
# the batches each is listed at: at batch 1 XLA sums the two 7x7 convs in
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
    if kh == kw == 1 and tuple(strides) == (1, 1):
        p = xt
    else:
        p = P.im2col(xt, kh, kw, strides, (1, 1), "SAME", 0.0)
    return fma_gemm(p.contiguous(),
                    torch.from_numpy(w_hwio.reshape(-1, oc))).numpy()


def test_every_listed_shape_has_a_case():
    assert {(b, _HW[s], _HW[s], *s) for b, s in _CASES} == \
        set(P.FMA_ORDER_SHAPES)


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


def test_full_width_fake_quant_no_further_than_recorded():
    """The open fault as ROADMAP §C records it: on the fixture's 4 frames
    the port's fake-quant is 5 LSB from the jitted reference (4 on the
    first 2 frames), since the depthwise convs sum in XLA's FMA order
    (``tests/test_torch_tflite_dw_fma.py``). The 2 LSB asked does not
    hold; this holds the distance from growing."""
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
    assert int(np.abs(got - want).max()) <= 5
    assert int(np.abs(got[:2] - want[:2]).max()) <= 4
