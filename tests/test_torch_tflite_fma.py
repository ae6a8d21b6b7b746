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
  as XLA contracts them; so does frame 0 alone at batch 1;
* the FULLY_CONNECTED at the batches ``FMA_ORDERS`` lists equals the
  reference's jitted ``jnp.matmul`` bit for bit, and at batch 4 (unlisted)
  is no further from it than recorded;
* the global-pool MEAN (``mean_fma``: one chain of contracted
  dequantizing FMAs, then the float32 reciprocal of the count) equals the
  jitted ``jnp.mean`` of a fake-quantized input at batches 1, 4 and 64,
  and on the fixture its snapped output (the FC's input) equals the
  reference's;
* the committed batch-64 reference output
  (``fixtures/mobilenet_v2_1.0_224_int8_fake_quant_b64.npz``, which the
  card's phase 16 holds its output against) is still what the jitted
  reference gives."""
from fractions import Fraction
from pathlib import Path

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
# other orders, two of them listed
_CASES = [(b, shape) for shape in sorted(_HW) for b in (1, 4, 64)
          if (b, _HW[shape]) != (1, 7)] + [
    (1, (1, 1, 1, 1, 320, 1280)), (1, (1, 1, 1, 1, 960, 320))]
# the FULLY_CONNECTED (batch, 1280) x (1280, 1001), keyed as a 1x1 conv of
# a 1x1 input
_FC_BATCHES = (1, 64)
_FC_KEY = (1, 1, 1, 1, 1, 1, 1280, 1001)


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
    assert {(b, _HW[s], _HW[s], *s) for b, s in _CASES} | \
        {(b, *_FC_KEY) for b in _FC_BATCHES} == set(P.FMA_ORDERS)


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


_MODEL = Path(__file__).resolve().parent / "fixtures" / \
    "mobilenet_v2_1.0_224_int8.tflite"


def _frames4():
    return np.random.default_rng(0).integers(
        -128, 128, (4, 224, 224, 3)).astype(np.int8)


@pytest.mark.parametrize("batch", _FC_BATCHES)
def test_listed_fully_connected_equals_the_reference_matmul(batch):
    order = P.FMA_ORDERS[(batch, *_FC_KEY)]
    rng = np.random.default_rng(1001 + batch)
    x = rng.standard_normal((batch, 1280)).astype(np.float32)
    w = (rng.standard_normal((1280, 1001)) / np.sqrt(1280)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda a, b: jnp.matmul(
        a, b, precision=jax.lax.Precision.HIGHEST))(x, w))
    got = fma_gemm(torch.from_numpy(x), torch.from_numpy(w), *order).numpy()
    assert int((got != want).sum()) == 0


@pytest.mark.parametrize("batch", (1, 4, 64))
def test_mean_fma_equals_the_jitted_mean_of_a_fake_quantized_input(batch):
    """XLA fuses the snap's dequantizing multiply into the MEAN's reduce
    and contracts it: fmaf(q - zp, s, acc) over the 7x7 window in (h, w)
    order, then a multiply by float32(1 / 49)."""
    assert (batch, 7, 7, 1280) in P.MEAN_FMA_SHAPES
    s, zp = np.float32(0.0235294122248888), np.float32(-128)
    q = np.random.default_rng(batch).integers(
        -128, 128, (batch, 7, 7, 1280)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.mean(
        (v - zp) * s, axis=(1, 2)))(q))
    total = P.mean_fma(torch.from_numpy(q - zp), float(s))
    got = (total * torch.tensor(np.float32(1) / np.float32(49))).numpy()
    assert int((got != want).sum()) == 0


def test_fixture_pool_and_fully_connected_against_the_jitted_reference():
    """ROADMAP §C, C1, on the fixture's 4 frames at batch 4: the MEAN's
    pre-snap values equal the reference's (the port's ``mean_fma`` sum
    times float32(1 / 49)); its snapped output, the FC's input, equals the
    reference's; the FC (not listed at batch 4: its first 960 columns
    sum in K blocks of 512, its last 41 in an order not found) runs the
    float64 GEMM, and its pre-snap values are no further from the
    reference's than recorded."""
    import nnstreamer_tpu.models.tflite_import as R
    frames = _frames4()
    opts = {"quantized_exec": "fake-quant", "batch": "4"}
    rfn, _, _ = R.load_tflite(str(_MODEL), opts)
    orig_mean, orig_mm, orig_fused = jnp.mean, jnp.matmul, R._fused

    def caught(x, what):
        seen = {}

        def mean(a, *args, **kw):
            seen["mean"] = orig_mean(a, *args, **kw)
            return seen["mean"]

        def mm(a, b, **kw):
            seen["fc_in"] = a
            return orig_mm(a, b, **kw)

        def fused(act, y):
            if y.ndim == 2 and y.shape[-1] == 1001:
                seen["fc"] = y
            return orig_fused(act, y)
        jnp.mean, jnp.matmul, R._fused = mean, mm, fused
        try:
            rfn(x)
        finally:
            jnp.mean, jnp.matmul, R._fused = orig_mean, orig_mm, orig_fused
        return tuple(seen[k] for k in what)
    want_mean, = (np.asarray(v) for v in jax.jit(
        lambda x: caught(x, ("mean",)))(frames))
    want_in, want_fc = (np.asarray(v) for v in jax.jit(
        lambda x: caught(x, ("fc_in", "fc")))(frames))

    seen = {}
    orig_pmean, orig_gemm, orig_pfused = P.mean_fma, P._gemm_float, \
        P._fused

    def pmean(k, s):
        seen["sum"] = orig_pmean(k, s)
        return seen["sum"]

    def gemm_float(precision):
        g = orig_gemm(precision)

        def rec(a, b):
            if b.shape[-1] == 1001 and a.device.type == "cpu":
                seen["fc_in"] = a.numpy().copy()
            return g(a, b)
        return rec

    def pfused(act, y):
        if y.dim() == 2 and y.shape[-1] == 1001 and y.device.type == "cpu":
            seen["fc"] = y.numpy().copy()
        return orig_pfused(act, y)
    P.mean_fma, P._gemm_float, P._fused = pmean, gemm_float, pfused
    try:
        pfn, _, _ = P.load_tflite(str(_MODEL), opts, device="cpu")
        pfn(torch.from_numpy(frames))
    finally:
        P.mean_fma, P._gemm_float, P._fused = orig_pmean, orig_gemm, \
            orig_pfused
    got_mean = (seen["sum"] * torch.tensor(
        np.float32(1) / np.float32(49))).numpy()
    np.testing.assert_array_equal(got_mean, want_mean)
    np.testing.assert_array_equal(seen["fc_in"], want_in)
    # recorded (ROADMAP §C): 3576 of 4004 apart, by at most 1.9073486e-06
    # (8.4e-5 of the output's step, 0.0227744)
    apart = int((seen["fc"] != want_fc).sum())
    gap = float(np.abs(seen["fc"].astype(np.float64) - want_fc).max())
    assert apart <= 3576 and gap <= 1.9073486328125e-06


def test_full_width_fake_quant_at_batch_1_no_further_than_recorded():
    """Frame 0 of the fixture's 4 alone, at batch 1 (SingleShot's and a
    one-frame appsrc's batch): 0 LSB from the jitted reference, though
    three of the 7x7 convs at batch 1 are not in XLA's order (ROADMAP
    §C, C2)."""
    import nnstreamer_tpu.models.tflite_import as R
    x = _frames4()[:1]
    opts = {"quantized_exec": "fake-quant", "batch": "1"}
    rfn, _, _ = R.load_tflite(str(_MODEL), opts)
    pfn, _, _ = P.load_tflite(str(_MODEL), opts, device="cpu")
    want = np.asarray(jax.jit(rfn)(x)[0]).astype(np.int64)
    got = pfn(torch.from_numpy(x))[0].numpy().astype(np.int64)
    assert int(np.abs(got - want).max()) <= 0


def test_committed_batch_64_reference_output_is_the_references():
    """The fixture phase 16 holds the card's batch-64 fake-quant output
    against: the jitted reference on the same 64 seeded frames still
    gives it (only the reference runs here)."""
    import json
    import sys
    sys.path.insert(0, str(_MODEL.parent))
    import make_fake_quant_b64_reference as M
    saved = np.load(M.OUT)
    assert json.loads(str(saved["options"])) == M.OPTIONS
    assert (int(saved["seed"]), int(saved["low"]), int(saved["high"])) == \
        (M.SEED, M.LOW, M.HIGH)
    np.testing.assert_array_equal(M.reference_output(), saved["out"])


def test_pitched_rows_hold_the_same_values():
    """op 0's im2col and the MEAN's window lie on a pitch of a multiple of
    4 floats for the kernel's 16-byte copies: the same values, and the
    same FMA chains, as the dense rows."""
    from nnstreamer_tpu_torch.ops.fma_gemm import padded_rows
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 9, 9, 3, generator=g)
    dense = P.im2col(x, 3, 3, (2, 2), (1, 1), "SAME", 0.0)
    pitched = P.im2col(x, 3, 3, (2, 2), (1, 1), "SAME", 0.0, pitched=True)
    assert torch.equal(dense, pitched) and pitched.stride(-2) == 28
    rows = padded_rows(10, 49, "cpu")
    assert rows.shape == (10, 49) and rows.stride() == (52, 1)
    rows.copy_(torch.randn(10, 49, generator=g))
    w = torch.randn(49, 3, generator=g)
    assert torch.equal(fma_gemm(rows, w), fma_gemm(rows.contiguous(), w))


@pytest.mark.parametrize("batch,gemms,depthwise", [(64, 37, 17), (4, 36, 17),
                                                   (1, 31, 17)])
def test_kernel_launches_a_forward(batch, gemms, depthwise):
    """The launches a fake-quant forward of the fixture gives each kernel,
    as phase 16 of chip_smoke.py and ops/tune_fake_quant.py count them:
    the listed convs (six of the eight 7x7 convs are not listed at batch
    1), the FC where its batch is listed, and the MEAN."""
    from nnstreamer_tpu_torch.ops.tune_fake_quant import forward_shapes
    g, d = forward_shapes(batch)
    assert (sum(g.values()), sum(d.values())) == (gemms, depthwise)
