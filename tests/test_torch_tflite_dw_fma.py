"""The port's depthwise FMA order (``ops/depthwise_fma.py``,
``models/tflite_import.py::DEPTHWISE_FMA_SHAPES``) against nnstreamer_tpu's
jitted ``depthwise_shift_add`` on XLA:CPU.

* every listed depthwise conv (one of the int8 MobileNet-v2 fixture's, at
  its spatial size, at batch 1, 4 or 64; at 64 the port is compared on 3
  of the reference's images), fed a fake-quantized activation
  ``k * s`` with the weights, scale and bias as constants, as the
  fake-quant forward feeds it: the port equals the jitted reference bit
  for bit. At stride 1 that needs the reassociated centre tap
  (``k * float32(s * w)``); the plain chain alone does not;
* on a plain float input the jitted reference is the FMA chain without
  the reassociated tap;
* ``depthwise_fma_plain`` is the correctly rounded chain (exact rational
  arithmetic on a small case, the reassociated tap included)."""
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax  # noqa: E402

import nnstreamer_tpu.models.tflite_import as R  # noqa: E402
import nnstreamer_tpu_torch.models.tflite_import as P  # noqa: E402
from nnstreamer_tpu_torch.ops.depthwise_fma import (  # noqa: E402
    depthwise_fma_plain, direct_tap)

# (in_hw, stride, channels) of the fixture's depthwise convs (3x3, SAME)
_SHAPES = sorted({(s[1], s[5], s[7]) for s in P.DEPTHWISE_FMA_SHAPES})
_CASES = [(b, s) for s in _SHAPES for b in (1, 4, 64)]


def _case_id(case):
    b, (hw, st, c) = case
    return f"{hw}x{hw}x{c}-s{st}-batch{b}"


def _inputs(batch, hw, st, c):
    rng = np.random.default_rng(hw * 7 + st * 3 + c + batch)
    k = rng.integers(-128, 128, (batch, hw, hw, c)).astype(np.float32)
    s = np.float32(rng.uniform(0.005, 0.05))
    w = (rng.standard_normal((1, 3, 3, c)) / 3).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    return k, s, w, b


def test_every_listed_shape_has_a_case():
    assert {(b, hw, hw, 3, 3, st, st, c, c) for b, (hw, st, c) in _CASES} \
        == set(P.DEPTHWISE_FMA_SHAPES)


@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_listed_shape_equals_the_jitted_reference_bit_for_bit(case):
    """The reference runs at the listed batch (XLA's order is a function of
    the whole shape); at batch 64 the port, whose sums are per image, is
    compared on the first, a middle and the last image of it."""
    batch, (hw, st, c) = case
    k, s, w, b = _inputs(batch, hw, st, c)
    ref = jax.jit(lambda kk: R.depthwise_shift_add(
        kk * s, w, (st, st), "SAME", (1, 1)) + b)
    want = np.asarray(ref(k))
    if batch == 64:
        images = [0, 31, 63]
        k, want = k[images], want[images]
    x = torch.from_numpy(k) * torch.tensor(s)       # the port's fake-quant
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    oh, ow, pads = P.explicit_padding(hw, hw, 3, 3, (st, st), (1, 1),
                                      "SAME")
    if batch == 64:   # the listed path itself, on the three images
        y = depthwise_fma_plain(x, wt, (st, st), (1, 1), pads, (oh, ow),
                                float(s))
    else:             # through the importer's choice of path
        y = P._depthwise(x, wt, (st, st), "SAME", (1, 1), float(s))
    got = (y + bt).numpy()
    assert got.shape == want.shape
    assert int((got != want).sum()) == 0
    if st == 1:  # the reassociated centre tap is what makes it equal
        plain = (depthwise_fma_plain(x, wt, (1, 1), (1, 1), pads, (oh, ow))
                 + bt).numpy()
        assert int((plain != want).sum()) > 0


@pytest.mark.parametrize("shape", [(56, 1, 144), (28, 2, 192)],
                         ids=["s1", "s2"])
def test_float_input_is_the_chain_without_the_direct_tap(shape):
    hw, st, c = shape
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, hw, hw, c)).astype(np.float32)
    w = (rng.standard_normal((1, 3, 3, c)) / 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b: R.depthwise_shift_add(
        a, b, (st, st), "SAME", (1, 1)))(x, w))
    oh, ow, pads = P.explicit_padding(hw, hw, 3, 3, (st, st), (1, 1), "SAME")
    got = depthwise_fma_plain(torch.from_numpy(x), torch.from_numpy(w),
                              (st, st), (1, 1), pads, (oh, ow)).numpy()
    np.testing.assert_array_equal(got, want)


def _fmaf(a, b, c) -> np.float32:
    """float32(a*b + c) rounded once, to nearest even, from exact rationals."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(exact))
    cands = [r, np.nextafter(r, np.float32(np.inf)),
             np.nextafter(r, np.float32(-np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.asarray(v).view(np.uint32)) & 1))


def test_plain_version_is_the_correctly_rounded_chain():
    rng = np.random.default_rng(11)
    s = np.float32(0.0204)
    k = rng.integers(-128, 128, (2, 5, 5, 3)).astype(np.float32)
    x = (k * s).astype(np.float32)
    w = rng.standard_normal((1, 3, 3, 3)).astype(np.float32)
    w[0, 0, 0] *= np.float32(1 + 2 ** -20)  # near-cancelling products
    oh, ow, pads = P.explicit_padding(5, 5, 3, 3, (1, 1), (1, 1), "SAME")
    assert direct_tap((5, 5), (3, 3), (1, 1), (1, 1), pads, (oh, ow)) == 4
    got = depthwise_fma_plain(torch.from_numpy(x), torch.from_numpy(w),
                              (1, 1), (1, 1), pads, (oh, ow),
                              float(s)).numpy()
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    kp = np.pad(k, ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = np.zeros_like(got)
    for idx in np.ndindex(*got.shape):
        n, i, j, ch = idx
        terms = []
        for t in range(9):
            ky, kx = divmod(t, 3)
            if t == 4:
                terms.append((kp[n, i + 1, j + 1, ch],
                              np.float32(s * w[0, 1, 1, ch])))
            else:
                terms.append((xp[n, i + ky, j + kx, ch], w[0, ky, kx, ch]))
        acc = _fmaf(terms[0][0], terms[0][1],
                    np.float32(terms[1][0] * terms[1][1]))
        for a, b in terms[2:]:
            acc = _fmaf(a, b, acc)
        want[idx] = acc
    np.testing.assert_array_equal(got, want)
