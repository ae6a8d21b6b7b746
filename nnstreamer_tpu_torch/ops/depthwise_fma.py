"""Depthwise convolution in XLA:CPU's fused multiply-add order: the CUDA
kernel, its wrapper and its plain PyTorch version.

nnstreamer_tpu writes a depthwise conv as a chain of shifted multiply-adds
(``acc + sl * w`` over the kh*kw taps in (ky, kx) order). Under ``jit``
XLA:CPU contracts that chain into fused multiply-adds: the first add
becomes ``fmaf(sl_0, w_0, round(sl_1 * w_1))`` and every later one
``fmaf(sl_k, w_k, acc)``. When the input is a fake-quantized activation
``k * s`` (``k`` integer-valued, ``s`` the tensor's scale, a constant), the
tap whose slice is the whole unpadded input (the centre tap of a stride-1
SAME window) reads that input directly, and XLA's simplifier reassociates
its product to ``k * float32(s * w)``; the other taps read the padded
copy and keep ``x * w``. At the shapes where a test shows it
(``models/tflite_import.py::DEPTHWISE_FMA_SHAPES``) the port sums in that
order, so a fake-quant forward snaps each such op to the reference's step.

``depthwise_fma`` is the wrapper. On CPU tensors it runs
``depthwise_fma_plain``, whose steps are ``ops/fma_gemm.py::_fma_step``
(a float64 product and sum, redone by rounding to odd where rounding twice
would differ from one ``fmaf``); the plain version takes any window. On
CUDA tensors it launches ``csrc/depthwise_fma.cu`` (``__fmaf_rn`` in that
order; persistent blocks over output tiles, each tile's input staged by a
three-slot ``cp.async`` ring, 4 channels a thread; ``tile_for`` picks the
tile), which is built for what the listed shapes need: a 3x3 window,
undilated, channel multiplier 1, stride 1 or 2 (a C that is not a
multiple of 4 is zero-padded to one). Anything else on the card raises, as does a launch that fails;
``depthwise_fma.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from .build import load_kernel
from .fma_gemm import _CPU_BLOCK, _fma_step


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype is not torch.float32 or w.dtype is not torch.float32:
        raise TypeError(
            f"depthwise_fma needs float32, got {x.dtype}/{w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[0] != 1 or \
            w.shape[3] % x.shape[3]:
        raise ValueError(f"depthwise_fma: x (N, H, W, C) and w (1, kh, kw, "
                         f"C*mult) do not match: {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")


def direct_tap(x_hw, kernel_hw, strides, dilation, pads, out_hw) -> int:
    """Index (ky*kw + kx) of the tap whose slice of the padded input is the
    whole unpadded input, or -1 where no tap is."""
    (h, wd), (kh, kw), (pt, _), (pl, _) = x_hw, kernel_hw, *pads
    if tuple(strides) != (1, 1) or tuple(out_hw) != (h, wd):
        return -1
    dh, dw = dilation
    if pt % dh or pl % dw or pt // dh >= kh or pl // dw >= kw:
        return -1
    return (pt // dh) * kw + pl // dw


def depthwise_fma_plain(x: torch.Tensor, w: torch.Tensor, strides,
                        dilation, pads, out_hw,
                        in_scale: Optional[float] = None) -> torch.Tensor:
    """NHWC depthwise conv of ``x`` by tflite weights ``w`` [1, kh, kw,
    C*mult], zero-padded by ``pads`` ((top, bottom), (left, right)) to the
    output size ``out_hw``, summed as correctly rounded float32 FMAs
    (module docstring). ``in_scale``: the scale ``s`` of a fake-quantized
    input (``x == float32(k * s)``), whose direct tap is reassociated. On
    the CPU the output rows go in blocks under PyTorch's thread grain, as
    ``fma_gemm_plain``'s do."""
    _check(x, w)
    kh, kw, oc = (int(d) for d in w.shape[1:])
    n, c = int(x.shape[0]), int(x.shape[3])
    sh, sw = strides
    dh, dw = dilation
    oh, ow = out_hw
    (pt, pb), (pl, pr) = pads
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    if oc != c:  # channel multiplier: output channel o reads o // mult
        xp = torch.repeat_interleave(xp, oc // c, dim=-1)
    w64 = w[0].double()
    direct = -1 if in_scale is None else direct_tap(
        x.shape[1:3], (kh, kw), strides, dilation, pads, out_hw)
    if direct >= 0:   # the reassociated tap's weight, float32(s * w)
        w64 = w64.clone()
        ky, kx = divmod(direct, kw)
        w64[ky, kx] = (torch.tensor(in_scale, dtype=torch.float32)
                       * w[0, ky, kx]).double()
    out = torch.empty(n, oh, ow, oc, dtype=torch.float32, device=x.device)
    # blocks of (images, output rows): the whole tensor on a card
    if x.device.type == "cpu":
        imgs, rows = 1, max(1, _CPU_BLOCK // (ow * oc))
    else:
        imgs, rows = n, oh
    for b in range(0, n, imgs):
        b1 = b + imgs
        for i0 in range(0, oh, rows):
            i1 = min(oh, i0 + rows)

            def prod(k):
                ky, kx = divmod(k, kw)
                y0 = i0 * sh + ky * dh
                sl = xp[b:b1, y0:y0 + sh * (i1 - i0 - 1) + 1:sh,
                        kx * dw:kx * dw + sw * (ow - 1) + 1:sw, :].double()
                if k == direct:  # round(x / s) is k exactly: |k| <= 255
                    sl = torch.round(sl / float(
                        torch.tensor(in_scale, dtype=torch.float32)))
                return sl * w64[ky, kx]   # exact: two float32 factors
            if kh * kw == 1:
                out[b:b1, i0:i1] = prod(0).float()
                continue
            # quantized taps land on float32 midpoints in most blocks:
            # redo every step rather than screen for them
            acc = _fma_step(prod(0), prod(1).float().double(), screen=False)
            for k in range(2, kh * kw):
                acc = _fma_step(prod(k), acc, screen=False)
            out[b:b1, i0:i1] = acc.float()
    return out


@functools.cache
def _kernel():
    fn = load_kernel("depthwise_fma").nns_depthwise_fma
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + \
        [ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# an SM's shared memory for blocks (bytes), its threads, a block's threads;
# the kernel's ring holds 2 to 4 tiles' inputs, all but one in flight
_SMEM_SM, _THREADS_SM, _THREADS_MAX = 227 * 1024, 2048, 512
_SLOTS = (2, 3, 4)
# The tile measured fastest (ops/tune_fake_quant.py on an H100 SXM, 700 W)
# at each depthwise shape of a batch-64 fake-quant forward of the int8
# MobileNet-v2 fixture: (N, OH, OW, C, stride): (TH, TW, CB, rows, slots)
_TUNED = {
    (64, 7, 7, 960, 1): (7, 7, 64, 7, 3),
    (64, 14, 14, 384, 1): (14, 14, 32, 14, 2),
    (64, 14, 14, 576, 1): (14, 7, 64, 14, 2),
    (64, 7, 7, 576, 2): (7, 7, 96, 4, 2),
    (64, 28, 28, 192, 1): (28, 28, 16, 14, 2),
    (64, 14, 14, 192, 2): (8, 7, 32, 4, 2),
    (64, 56, 56, 144, 1): (14, 7, 72, 7, 2),
    (64, 28, 28, 144, 2): (14, 7, 48, 4, 2),
    (64, 112, 112, 32, 1): (14, 7, 32, 7, 3),
    (64, 56, 56, 96, 2): (8, 8, 96, 4, 2),
}
# bytes an SM should have in flight to keep its share of the memory busy
_INFLIGHT = 48 * 1024


def _sizes(n: int, cap: int):
    """Whole spans of ``n``, then the widths that split it into a few
    tiles, largest first, none above ``cap``."""
    out = {n} if n <= cap else set()
    out |= {d for d in (32, 28, 16, 14, 8, 7, 4) if d < n and d <= cap}
    return sorted(out, reverse=True)


def tile_shape(n: int, oh: int, ow: int, c: int, stride: int, sms: int,
               th: int, tw: int, cb: int, rows: int, slots: int) -> dict:
    """A tile's fields as the kernel takes them, with its threads and the
    grid: the tiles, or the blocks the card holds at once, the fewer."""
    in_h, in_w = (th - 1) * stride + 3, (tw - 1) * stride + 3
    threads = cb // 4 * tw * -(-th // rows)
    per_sm = min(_SMEM_SM // (slots * in_h * in_w * cb * 4),
                 _THREADS_SM // threads)
    tiles = n * -(-oh // th) * -(-ow // tw) * -(-c // cb)
    return {"th": th, "tw": tw, "cb": cb, "rows": rows, "slots": slots,
            "threads": threads, "grid": min(tiles, sms * per_sm)}


@functools.lru_cache(maxsize=None)
def tile_for(n: int, oh: int, ow: int, c: int, stride: int,
             sms: int) -> dict:
    """The kernel's tile for an (n, oh, ow, c) output at ``stride`` on a
    card of ``sms`` SMs (:func:`tile_shape`'s fields): ``_TUNED``'s for its
    shapes; else the one that minimizes a model of the busiest SM's bytes:
    every tile it runs reads its input, halo and padding included, and
    writes its outputs, slowed where the SM's resident blocks keep fewer
    than 48 KiB in flight or hold fewer than 256 threads, and where a
    pixel's run of channels is short (at least 64 bytes where C allows,
    128 or more preferred)."""
    tuned = _TUNED.get((n, oh, ow, c, stride))
    if tuned:
        return tile_shape(n, oh, ow, c, stride, sms, *tuned)
    best = None
    cbs = [cb for cb in range(min(c, 16), min(c, 192) + 1, 4)
           if c % cb == 0]
    for th in _sizes(oh, 32):
        for tw in _sizes(ow, 32):
            in_h, in_w = (th - 1) * stride + 3, (tw - 1) * stride + 3
            for cb in cbs:
                stage = in_h * in_w * cb * 4
                for runs in (1, 2, 4, 8):
                    rows = -(-th // runs)
                    threads = cb // 4 * tw * -(-th // rows)
                    for slots in _SLOTS:
                        if threads > _THREADS_MAX or \
                                slots * stage > _SMEM_SM:
                            continue
                        t = tile_shape(n, oh, ow, c, stride, sms, th, tw,
                                       cb, rows, slots)
                        tiles = n * -(-oh // th) * -(-ow // tw) * (c // cb)
                        busy = min(t["grid"] // sms or 1, -(-tiles // sms))
                        moved = stage + th * tw * cb * 4
                        slow = max(1.0, _INFLIGHT /
                                   (busy * (slots - 1) * stage),
                                   256 / (busy * threads)) * (1 + 4 / cb)
                        cost = -(-tiles // sms) * moved * slow
                        key = (cost, -threads, slots)
                        if best is None or key < best[0]:
                            best = (key, t)
    if best is None:
        raise ValueError(f"depthwise_fma: no tile for a ({n}, {oh}, {ow}, "
                         f"{c}) output at stride {stride}")
    return best[1]


def depthwise_fma(x: torch.Tensor, w: torch.Tensor, strides, dilation, pads,
                  out_hw, in_scale: Optional[float] = None) -> torch.Tensor:
    """x (N, H, W, C) float32 by w (1, kh, kw, C*mult) float32 → (N, oh,
    ow, C*mult) float32, in XLA:CPU's FMA order (arguments as
    :func:`depthwise_fma_plain`)."""
    _check(x, w)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return depthwise_fma_plain(x, w, strides, dilation, pads, out_hw,
                                   in_scale)
    if x.device.type == "meta":  # shape tracing
        return x.new_empty(x.shape[0], *out_hw, w.shape[3])
    if x.device != w.device or x.device.type != "cuda":
        raise ValueError(f"depthwise_fma needs x and w on one CUDA device or "
                         f"both on the CPU, got {x.device} and {w.device}")
    kh, kw, oc = (int(d) for d in w.shape[1:])
    n, h, wd, c = (int(d) for d in x.shape)
    oh, ow = out_hw
    (pt, _), (pl, _) = pads
    if (kh, kw) != (3, 3) or oc != c or tuple(dilation) != (1, 1) or \
            tuple(strides) not in ((1, 1), (2, 2)):
        raise ValueError(
            f"depthwise_fma's kernel takes a 3x3 window, undilated, channel "
            f"multiplier 1, stride 1 or 2; got window {kh}x{kw}, "
            f"multiplier {oc // c}, dilation {tuple(dilation)}, strides "
            f"{tuple(strides)}")
    direct = -1 if in_scale is None else direct_tap(
        (h, wd), (kh, kw), strides, dilation, pads, out_hw)
    if direct not in (-1, 4):
        raise ValueError(f"depthwise_fma's kernel reassociates the centre "
                         f"tap alone; pads {pads} make it tap {direct}")
    # the kernel reads and writes 16-byte runs of 4 channels: other
    # channel counts are zero-padded to a multiple of 4 (each channel's
    # chain is its own) and cut back after
    c4 = -(-c // 4) * 4
    if c4 != c:
        x, w = F.pad(x, (0, c4 - c)), F.pad(w, (0, c4 - c))
    x = x.contiguous() if x.data_ptr() % 16 == 0 else x.clone(
        memory_format=torch.contiguous_format)
    w = w.contiguous() if w.data_ptr() % 16 == 0 else w.clone(
        memory_format=torch.contiguous_format)
    out = torch.empty(n, oh, ow, c4, dtype=torch.float32, device=x.device)
    if out.numel():
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        t = tile_for(n, oh, ow, c4, int(strides[0]), sms)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _kernel()(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, h,
                            wd, c4, oh, ow, strides[0], pt, pl, direct,
                            0.0 if in_scale is None else in_scale, t["th"],
                            t["tw"], t["cb"], t["rows"], t["slots"],
                            t["grid"], stream)
        if err:
            raise RuntimeError(
                f"depthwise_fma kernel launch failed: CUDA error {err}")
        depthwise_fma.launches += 1
    return out if c4 == c else out[..., :c]


depthwise_fma.launches = 0
