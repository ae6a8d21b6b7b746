"""The plain references agree with the program at a small size on the
CPU, and the int8 reference with TFLite's own interpreter where one is
installed."""
import json
from dataclasses import replace

import numpy as np
import pytest
import torch

from benchmark import core
from benchmark.references import mobilenet_v2 as R
from benchmark.references.tflite_int8 import TfliteInt8Reference, int8_input
from benchmark.traffic import generator

MANIFEST = core.load_manifest()
BF16 = core.find_cell(MANIFEST, "mobilenet_v2_bf16.nvdec_live_b16")
INT8 = core.find_cell(MANIFEST, "mobilenet_v2_int8_tflite.nvdec_b64")
FIXTURE = core.ROOT / INT8.config["model_file"]


def _frames(n, size, seed):
    mix = dict(BF16.traffic, frame=[size, size, 3], pool_buffers=1, frames_per_buffer=n)
    return generator.make_pool(mix, seed, "cpu")[0]


def test_mobilenet_reference_is_the_programs_float32_forward():
    from nnstreamer_tpu_torch.models.mobilenet_v2 import filter_model_u8

    cfg = BF16.config
    w = R.make_weights(cfg, 2**31 + 5, _frames(4, 64, 1), torch.bfloat16)
    entry = replace(filter_model_u8, base=replace(
        filter_model_u8.base, params=R.flax_tree(cfg, w), compute_dtype="float32"))
    x = _frames(3, 64, 2)
    got = entry.make(device="cpu")(x)
    want = R.forward(cfg, w, x)
    assert got.shape == (3, cfg["num_classes"])
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * float(want.std()))


def test_mobilenet_weights_repeat_from_their_seed():
    cfg, calib = BF16.config, _frames(4, 32, 1)
    a = R.make_weights(cfg, 7, calib)
    b = R.make_weights(cfg, 7, calib)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fc.w"], R.make_weights(cfg, 8, calib)["fc.w"])


def test_tflite_reference_matches_the_programs_fake_quant_within_its_limit():
    from nnstreamer_tpu_torch.models.tflite_import import load_tflite

    x = _frames(1, 224, 3)
    fn, _, _ = load_tflite(str(FIXTURE), {"quantized_exec": "fake-quant", "batch": "1"},
                           device="cpu")
    got = torch.as_tensor(fn(int8_input(x))[0]).to(torch.int32)
    want = TfliteInt8Reference(FIXTURE)(int8_input(x)).to(torch.int32)
    assert int((got - want).abs().max()) <= INT8.config["limits"]["logit_lsb"]


def test_tflite_reference_is_tflites_own_semantics():
    tf = pytest.importorskip("tensorflow")
    it = tf.lite.Interpreter(
        model_path=str(FIXTURE),
        experimental_op_resolver_type=tf.lite.experimental.OpResolverType.BUILTIN_REF)
    it.allocate_tensors()
    ref = TfliteInt8Reference(FIXTURE)
    for seed in (0, 1):
        x = np.random.default_rng(seed).integers(-128, 128, (1, 224, 224, 3)).astype(np.int8)
        it.set_tensor(it.get_input_details()[0]["index"], x)
        it.invoke()
        want = it.get_tensor(it.get_output_details()[0]["index"])
        assert np.array_equal(ref(torch.from_numpy(x)).numpy(), want)


def test_int8_input_is_the_lines_transform():
    x = torch.tensor([0, 1, 127, 128, 255], dtype=torch.uint8)
    assert int8_input(x).tolist() == [-128, -127, -1, 0, 127]


def test_configuration_files_name_their_model():
    cfg = json.loads((core.ROOT / "benchmark/configs/mobilenet_v2_int8_tflite.json").read_text())
    assert (core.ROOT / cfg["model_file"]).is_file()
