"""The tooling plane on the card (marker ``cuda``; skips without a card).
This file needs neither JAX nor nnstreamer_tpu:

    python -m pytest --noconftest -q -m cuda tests/test_torch_tooling_cuda.py

Phase 22 of chip_smoke.py in small form:

* ``entry.entry()`` exports MobileNet-v2 and runs it on cuda:0, bit-equal
  to the eager forward; ``dryrun_multichip(1)`` on a world-1 NCCL group
  gives the meshless loss;
* the ``codegen`` filter skeleton runs as ``framework=torch`` on the card;
* ``obs profile --launch`` of the ``tiny`` LM line on the card writes an
  artifact whose ``kernels`` section counts both kernels' launches;
* ``launch`` of a line without ``accelerator=cpu`` runs on the card.
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cli(argv):
    from nnstreamer_tpu_torch.__main__ import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    return rc, buf.getvalue()


def test_entry_on_the_card():
    from nnstreamer_tpu_torch import entry

    r = entry.entry()
    assert r.exported.is_cuda and r.bit_equal
    assert tuple(r.exported.shape) == (1, 1001)


def test_dryrun_multichip_world_of_one():
    from nnstreamer_tpu_torch import entry

    out = entry.dryrun_multichip(1)
    assert out["backend"] == "nccl"
    assert out["loss"] == out["meshless_loss"]


def test_codegen_filter_on_the_card(tmp_path):
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    path = tmp_path / "f.py"
    assert _cli(["codegen", "filter", str(path)])[0] == 0
    pipe = parse_launch(
        "tensor_src num-buffers=2 dimensions=8 types=float32 pattern=counter "
        f"! tensor_filter framework=torch model={path} ! tensor_sink name=o")
    got = []
    pipe.get("o").connect(lambda b: got.append(b.tensors[0]))
    pipe.run(timeout=60)
    assert [t.is_cuda for t in got] == [True, True]
    assert [float(t[0]) for t in got] == [0.0, 1.0]


def test_profile_artifact_counts_the_kernels(tmp_path):
    from nnstreamer_tpu_torch.models.lm_serving import tiny

    prompts = tmp_path / "p.raw"
    np.random.default_rng(0).integers(0, tiny.cfg.vocab, (2, 4, 12)) \
        .astype(np.int32).tofile(prompts)
    line = (f"filesrc location={prompts} blocksize=192 ! "
            "application/octet-stream ! tensor_converter input-dim=12:4 "
            "input-type=int32 ! tensor_generate model=nnstreamer_tpu_torch."
            f"models.lm_serving:tiny steps=5 ! filesink location="
            f"{tmp_path / 'o.raw'}")
    out = tmp_path / "a.json"
    rc, _ = _cli(["obs", "profile", "--launch", line, "--out", str(out)])
    assert rc == 0
    layers = tiny.cfg.layers
    assert json.loads(out.read_text())["kernels"] == {
        "decode_attention": 2 * 4 * layers, "flash_attention": 2 * layers}
    assert np.fromfile(tmp_path / "o.raw", np.int32).size == 2 * 5 * 4


def test_launch_runs_on_the_card():
    rc, out = _cli(["launch", "tensor_src num-buffers=2 dimensions=4 "
                    "types=float32 ! tensor_filter framework=torch "
                    "model=builtin://scaler?factor=2 ! tensor_sink",
                    "--timeout", "60"])
    assert rc == 0 and "EOS" in out
