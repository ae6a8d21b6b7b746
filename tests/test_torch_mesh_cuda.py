"""The mesh surfaces of serving on the card (marker ``cuda``; skips
without a card). This file needs neither JAX nor nnstreamer_tpu:

    python -m pytest --noconftest -q -m cuda tests/test_torch_mesh_cuda.py

Phase 21 of chip_smoke.py in small form, on a world-1 NCCL group (the
card's machine has one card; NCCL takes no two ranks on one device):

* ``tensor_filter custom=mesh:1x1`` and ``tensor_generate mesh=1x1`` on
  the ``tiny`` entry give the unmeshed line's tokens, through both CUDA
  kernels (launches counted), with outputs on the card;
* ``make_generate(mesh=dp,tp,sp = 1,1,1, context_parallel=True)`` on the
  card gives the unmeshed dense path's tokens and launches no kernel;
* a mesh on the card with ``accelerator=cpu`` is refused.
"""
import socket

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

LM = "nnstreamer_tpu_torch.models.lm_serving:tiny"


@pytest.fixture
def world1():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist

    from nnstreamer_tpu_torch.parallel import init_multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_multihost(f"127.0.0.1:{port}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        yield torch.device("cuda", torch.cuda.current_device())
    finally:
        dist.destroy_process_group()


def _launches():
    from nnstreamer_tpu_torch.ops.decode_attention import decode_attention
    from nnstreamer_tpu_torch.ops.flash_attention import flash_attention

    return decode_attention.launches, flash_attention.launches


def _line(element, prompt):
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    B, P = prompt.shape
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,"
        f"dimensions={P}:{B},types=int32 ! {element} name=f "
        "! tensor_sink name=out max-stored=64")
    got = []
    pipe.get("out").connect(lambda b: got.append(b.tensors[0]))
    pipe.play()
    pipe.get("in").push_buffer(prompt)
    pipe.get("in").end_of_stream()
    msg = pipe.wait(timeout=120)
    f = pipe.get("f")
    mesh = getattr(f, "backend_mesh", None) or getattr(f, "mesh", None)
    pipe.stop()
    assert msg is not None and msg.type is MessageType.EOS, msg
    return got, mesh


def test_meshed_lines_on_the_card_equal_the_unmeshed(world1):
    prompt = np.random.default_rng(3).integers(0, 64, (4, 6)).astype(
        np.int32)
    want, _ = _line(f"tensor_filter framework=torch model={LM}", prompt)
    d0, f0 = _launches()
    got, mesh = _line(f"tensor_filter framework=torch model={LM} "
                      "custom=mesh:1x1", prompt)
    d1, f1 = _launches()
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"dp": 1}
    assert got[0].is_cuda
    assert torch.equal(got[0].cpu(), want[0].cpu())
    # tiny: 2 layers, 8 steps → 7 decode steps
    assert (d1 - d0, f1 - f0) == (2 * 7, 2)
    toks, mesh = _line(f"tensor_generate model={LM} steps=8 mesh=1x1",
                       prompt)
    assert mesh is not None
    np.testing.assert_array_equal(np.concatenate(toks, axis=1),
                                  want[0].cpu().numpy()[:, 6:])


def test_context_parallel_on_the_card_equals_the_dense_path(world1):
    from dataclasses import replace

    from nnstreamer_tpu_torch.models.decoding import make_generate
    from nnstreamer_tpu_torch.models.lm_serving import tiny
    from nnstreamer_tpu_torch.parallel import make_mesh

    mesh = make_mesh(None, {"dp": 1, "tp": 1, "sp": 1})
    params = tiny.build_params(world1)
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, 64, (4, 7)).astype(np.int32)).to(world1)
    dense = replace(tiny.cfg, decode_attn="dense", prefill_attn="dense")
    with torch.inference_mode():
        want = make_generate(dense)(params, prompt, 9)
        before = _launches()
        got = make_generate(tiny.cfg, mesh=mesh, context_parallel=True)(
            params, prompt, 9)
        torch.cuda.synchronize()
    assert _launches() == before
    assert got.is_cuda and torch.equal(got, want)


def test_a_card_mesh_refuses_the_cpu(world1):
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    pipe = parse_launch(
        "tensor_src num-buffers=1 dimensions=4 types=float32 "
        "! tensor_filter framework=torch accelerator=cpu "
        "model=builtin://passthrough custom=mesh:dp=1 ! tensor_sink")
    pipe.play()
    msg = pipe.bus.wait_for((MessageType.ERROR,), timeout=30)
    pipe.stop()
    assert msg is not None
    assert "runs on cuda" in str(msg.data.get("error", ""))
