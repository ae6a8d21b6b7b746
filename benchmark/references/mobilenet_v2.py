"""Plain reference of MobileNetV2 (Sandler et al., arXiv:1801.04381,
Table 2), in PyTorch, and the seeded weights the benchmark serves.

The forward follows the paper: a 3x3 stride-2 convolution, the
inverted-residual bottlenecks of Table 2 (1x1 expansion by t, 3x3
depthwise with stride s on the first of n repeats, 1x1 linear
projection, the input added back where stride is 1 and the widths
agree), a 1x1 convolution to 1280 channels, a global average pool and a
fully connected layer to the classes. Batch normalisation is the folded
inference form, a scale and a bias per channel, followed by ReLU6
except after the projection. Padding is TensorFlow's "SAME", as in
TF-Slim's ``mobilenet_v2_1.0_224``. Input frames are uint8 NHWC, scaled
to [-1, 1] by ``x / 127.5 - 1``.

``forward(..., precision="float32")`` is the reference: float32 with
TF32 off. ``precision="fp8"`` is the control, the same forward computed
in float8 e4m3 where the program computes in bfloat16: every tensor an
operation reads or writes (frames after scaling, weights, convolution
outputs, batch-norm scales, biases and results, residual sums, pooled
features, logits) is rounded to e4m3 with one scale per tensor (its
largest magnitude at 448); products are summed in float32, as a tensor
core sums them.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# one layer: (name, kind, in channels, out channels, kernel, stride, relu6)
Layer = Tuple[str, str, int, int, int, int, bool]


def layers(cfg: Dict) -> Tuple[List[Layer], List[Tuple[int, bool]]]:
    """The convolutions in order, and for each bottleneck (the index of
    its first layer, whether its input is added back)."""
    out: List[Layer] = []
    blocks: List[Tuple[int, bool]] = []

    def add(name, kind, cin, cout, k, s, act):
        out.append((name, kind, cin, cout, k, s, act))

    stem = cfg["stem_channels"]
    add("stem", "conv", cfg["input_channels"], stem, 3, 2, True)
    cin, b = stem, 0
    for t, c, n, s in cfg["bottlenecks"]:
        for i in range(n):
            stride = s if i == 0 else 1
            hidden = cin * t
            blocks.append((len(out), stride == 1 and cin == c))
            if t != 1:
                add(f"b{b}.expand", "conv", cin, hidden, 1, 1, True)
            add(f"b{b}.dw", "dw", hidden, hidden, 3, stride, True)
            add(f"b{b}.project", "conv", hidden, c, 1, 1, False)
            cin, b = c, b + 1
    add("head", "conv", cin, cfg["head_channels"], 1, 1, True)
    return out, blocks


@torch.no_grad()
def make_weights(cfg: Dict, seed: int, calib_u8: torch.Tensor,
                 dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Seeded weights on the device of ``calib_u8`` in ``dtype``, drawn
    by one generator there in a few large calls. Kernels are normal,
    clipped at two deviations, over sqrt(fan-in). Each folded batch norm
    is set as a trained network's is, from its input's statistics: the
    convolution's output over the calibration frames is brought to mean
    ``beta`` and deviation ``gamma`` per channel, with ``gamma`` uniform
    in [0.75, 1.25] and ``beta`` normal with deviation 0.25. The
    classifier's bias is normal with deviation 0.1. Without the
    statistics the pooled features barely change from frame to frame."""
    device = calib_u8.device
    convs, blocks = layers(cfg)
    classes, head = cfg["num_classes"], cfg["head_channels"]
    shapes = []
    for name, kind, cin, cout, k, _, _ in convs:
        shapes.append((name + ".w", (cout, 1 if kind == "dw" else cin, k, k),
                       (1 if kind == "dw" else cin) * k * k))
    shapes.append(("fc.w", (classes, head), head))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    total = sum(int(np.prod(s)) for _, s, _ in shapes)
    flat = torch.randn(total, generator=gen, device=device).clamp_(-2, 2)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, fan_in in shapes:
        n = int(np.prod(shape))
        out[name] = (flat[at:at + n].view(shape) * fan_in ** -0.5).to(dtype)
        at += n
    chans = sum(c[3] for c in convs)
    gamma = torch.rand(chans, generator=gen, device=device) * 0.5 + 0.75
    beta = torch.randn(chans, generator=gen, device=device) * 0.25
    out["fc.b"] = (torch.randn(classes, generator=gen, device=device)
                   * 0.1).to(dtype)
    # a bottleneck whose input is added back starts with a small branch,
    # as a trained network's are: with every branch at full gain the
    # random network amplifies any rounding from layer to layer
    damp = {f"b{b}.project": 0.2 for b, (_, res) in enumerate(blocks) if res}
    at = 0
    with _exact_float32():
        x = _normalise(calib_u8)
        saved = None
        for step, layer in _walk(convs, blocks):
            if step == "save":
                saved = x
                continue
            if step == "add":        # a bottleneck's input added back
                x = x + saved
                continue
            name, kind, cin, cout, k, s, act = layer
            y = F.conv2d(_same(x, k, s), out[name + ".w"].float(), stride=s,
                         groups=cin if kind == "dw" else 1)
            mean = y.mean(dim=(0, 2, 3))
            std = (y.var(dim=(0, 2, 3)) + 1e-3).sqrt()
            scale = gamma[at:at + cout] * damp.get(name, 1.0) / std
            out[name + ".scale"] = scale.to(dtype)
            out[name + ".bias"] = (beta[at:at + cout] - mean * scale).to(dtype)
            at += cout
            x = _bn_act(y, out, name, act)
    return out


def flax_tree(cfg: Dict, w: Dict[str, torch.Tensor]) -> Dict:
    """The same weights as a flax parameter tree of numpy float32 arrays,
    the form the program's MobileNet-v2 entry takes as ``params``: conv
    kernels (kh, kw, in, out), depthwise kernels (kh, kw, 1, C), the
    dense kernel (in, out)."""
    convs, _ = layers(cfg)

    def arr(t):
        return t.float().cpu().numpy()

    def node(name, kind):
        k = arr(w[name + ".w"]).transpose(2, 3, 1, 0)
        d = {"bn_scale": arr(w[name + ".scale"]), "bn_bias": arr(w[name + ".bias"])}
        if kind == "dw":
            d["depthwise_kernel"] = k
        else:
            d["Conv_0"] = {"kernel": k}
        return d

    p: Dict = {"ConvBnRelu_0": node("stem", "conv")}
    blocks: Dict[int, List[str]] = {}
    for name, kind, *_ in convs:
        if name.startswith("b"):
            blocks.setdefault(int(name[1:name.index(".")]), []).append(name)
    kinds = {c[0]: c[1] for c in convs}
    for b, names in blocks.items():
        p[f"InvertedResidual_{b}"] = {
            f"ConvBnRelu_{i}": node(n, kinds[n]) for i, n in enumerate(names)}
    p["ConvBnRelu_1"] = node("head", "conv")
    p["Dense_0"] = {"kernel": arr(w["fc.w"]).T.copy(), "bias": arr(w["fc.b"])}
    return {"params": p}


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per tensor, back in float32."""
    amax = x.abs().amax().clamp(min=1e-12)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


def _same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """TensorFlow's SAME padding of an NCHW tensor for a k x k window."""
    h, w = x.shape[2], x.shape[3]
    ph = max((-(-h // s) - 1) * s + k - h, 0)
    pw = max((-(-w // s) - 1) * s + k - w, 0)
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


class _exact_float32:
    """TF32 off for cuDNN and matmuls inside, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def _normalise(frames_u8: torch.Tensor) -> torch.Tensor:
    return frames_u8.to(torch.float32).permute(0, 3, 1, 2) / 127.5 - 1.0


def _bn_act(y: torch.Tensor, w: Dict[str, torch.Tensor], name: str,
            act: bool, low=lambda t: t) -> torch.Tensor:
    scale = low(w[name + ".scale"].float())[:, None, None]
    bias = low(w[name + ".bias"].float())[:, None, None]
    y = low(low(y * scale) + bias)
    return y.clamp(0.0, 6.0) if act else y


def _walk(convs: List[Layer], blocks: List[Tuple[int, bool]]):
    """The forward's steps: ("conv", layer) for each layer, with ("save",
    None) before a bottleneck whose input is added back and ("add", None)
    after its projection."""
    residual = {i for i, res in blocks if res}
    open_block = False
    for i, layer in enumerate(convs):
        if i in residual:
            yield "save", None
            open_block = True
        yield "conv", layer
        if open_block and layer[0].endswith(".project"):
            yield "add", None
            open_block = False


@torch.no_grad()
def forward(cfg: Dict, w: Dict[str, torch.Tensor], frames_u8: torch.Tensor,
            precision: str = "float32") -> torch.Tensor:
    """(N, H, W, 3) uint8 frames → (N, classes) float32 logits, computed
    where ``frames_u8`` lies."""
    low = _fp8 if precision == "fp8" else (lambda t: t)
    convs, blocks = layers(cfg)
    with _exact_float32():
        x = low(_normalise(frames_u8))
        saved = None
        for step, layer in _walk(convs, blocks):
            if step == "save":
                saved = x
                continue
            if step == "add":
                x = low(x + saved)
                continue
            name, kind, cin, cout, k, s, act = layer
            y = low(F.conv2d(_same(x, k, s), low(w[name + ".w"].float()),
                             stride=s, groups=cin if kind == "dw" else 1))
            x = _bn_act(y, w, name, act, low)
        x = low(x.mean(dim=(2, 3)))
        return low(low(x @ low(w["fc.w"].float()).T) + low(w["fc.b"].float()))
