"""Training, MoE and the parallel layer on the card (marker ``cuda``;
skips without a card). This file needs neither JAX nor nnstreamer_tpu:

    python -m pytest --noconftest -q -m cuda tests/test_torch_train_cuda.py

Phase 19 of chip_smoke.py in small form:

* a dense and an MoE train step on the card equal the CPU's on the same
  weights (float32, TF32 off: loss within 1e-5 relative, updates within
  1e-4 relative L2);
* ``tensor_trainer`` trains on cuda:0 by default;
* an MoE LM served through both CUDA kernels picks the dense path's
  greedy tokens;
* a world-1 NCCL group: a meshed step (ring, ulysses, gspmd) equals the
  meshless one."""
import socket
import textwrap
from dataclasses import replace

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

CFG = dict(vocab=64, dim=32, heads=4, layers=2, max_seq=33)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("experts", [0, 4])
def test_train_step_on_the_card_equals_the_cpu(dev, experts):
    from nnstreamer_tpu_torch.models.transformer import (
        TransformerConfig, init_params, make_train_step, tree_leaves, tree_map)

    cfg = TransformerConfig(**CFG, moe_experts=experts)
    cpu = init_params(cfg, seed=0, device="cpu")
    card = tree_map(lambda p: p.to(dev), cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 64, (4, 33)).astype(np.int32))
    step, _, _ = make_train_step(cfg, None, lr=5e-2)
    new_cpu, loss_cpu = step(cpu, toks)
    new_card, loss_card = step(card, toks.to(dev))
    assert all(p.is_cuda for p in tree_leaves(new_card))
    assert abs(float(loss_card) - float(loss_cpu)) <= 1e-5 * float(loss_cpu)
    for a, b, p in zip(tree_leaves(new_card), tree_leaves(new_cpu),
                       tree_leaves(cpu)):
        assert _rel(a.cpu() - p, b - p) <= 1e-4


def test_moe_serving_through_the_kernels_equals_the_dense_path(dev):
    from nnstreamer_tpu_torch.models.decoding import make_generate
    from nnstreamer_tpu_torch.models.transformer import (
        TransformerConfig, init_params)
    from nnstreamer_tpu_torch.ops.decode_attention import decode_attention
    from nnstreamer_tpu_torch.ops.flash_attention import flash_attention

    cfg = TransformerConfig(**CFG, moe_experts=4, decode_attn="kernel",
                            prefill_attn="kernel")
    params = init_params(cfg, seed=1, device=dev)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, 64, (4, 8)).astype(np.int32)).to(dev)
    decode_attention.launches = flash_attention.launches = 0
    got = make_generate(cfg)(params, prompt, 12)
    assert (decode_attention.launches, flash_attention.launches) == (
        11 * cfg.layers, cfg.layers)
    want = make_generate(replace(cfg, decode_attn="dense",
                                 prefill_attn="dense"))(params, prompt, 12)
    assert torch.equal(got, want)


def test_tensor_trainer_trains_on_the_card(dev, tmp_path):
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    cfg = tmp_path / "lin.py"
    cfg.write_text(textwrap.dedent("""
        import torch

        def init(generator, example_inputs):
            x = example_inputs[0]
            return {"w": torch.zeros((x.shape[-1], 1), device=x.device)}

        def loss_fn(params, inputs, labels):
            return torch.mean((inputs[0] @ params["w"] - labels[0]) ** 2)
    """))
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,num_tensors=2,"
        "dimensions=3.1,types=float32.float32 ! tensor_trainer name=t "
        f"model-config={cfg} num-training-samples=16 epochs=2 "
        "custom=batch:4,lr:0.1,optimizer:sgd")
    pipe.play()
    try:
        backend = pipe.get("t").backend
        assert backend.device == dev
        rng = np.random.default_rng(0)
        for _ in range(32):
            x = rng.normal(size=3).astype(np.float32)
            pipe.get("in").push_buffer([x, np.array([x.sum()], np.float32)])
        pipe.get("in").end_of_stream()
        msg = pipe.bus.wait_for((MessageType.ELEMENT, MessageType.ERROR),
                                timeout=60)
    finally:
        pipe.stop()
    assert msg.type is MessageType.ELEMENT and msg.data["epochs"] == 2
    assert backend.params["w"].is_cuda
    assert backend.losses[1] < backend.losses[0]


def test_world1_nccl_meshed_steps_equal_the_meshless_one(dev):
    import torch.distributed as dist

    from nnstreamer_tpu_torch.models.transformer import (
        TransformerConfig, init_params, make_train_step, tree_leaves)
    from nnstreamer_tpu_torch.parallel import init_multihost, make_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_multihost(f"127.0.0.1:{port}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh(None, {"dp": 1, "tp": 1, "sp": 1})
        cfg = TransformerConfig(**CFG, moe_experts=4)
        params = init_params(cfg, seed=2, device=dev)
        toks = np.random.default_rng(2).integers(0, 64, (4, 33)).astype(
            np.int32)
        step, _, _ = make_train_step(cfg, None, lr=5e-2)
        want, want_loss = step(params, torch.from_numpy(toks).to(dev))
        for impl in ("ring", "ulysses", "gspmd"):
            mstep, shard, sharding = make_train_step(
                replace(cfg, attn_impl=impl), mesh, lr=5e-2)
            got, loss = mstep(shard(params), sharding(toks))
            assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(
                want_loss), impl
            for g, w, p in zip(tree_leaves(got), tree_leaves(want),
                               tree_leaves(params)):
                assert _rel(g - p, w - p) <= 1e-4, impl
    finally:
        dist.destroy_process_group()
