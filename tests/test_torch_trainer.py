"""The port's ``tensor_trainer`` (elements/trainer.py) and its torch trainer
backend (trainer/torch_trainer.py, under the reference's names ``optax``,
``jax`` and ``flax``) against nnstreamer_tpu's on the reference's own
launch lines (tests/test_trainer.py), both on the CPU.

The same linear-regression model is defined twice — in JAX for the
reference, in torch for the port — with the same zero init, and both read
the same datarepo files. What is compared is what the reference's run
reports (completion message fields, loss and accuracy histories), not its
assertions. A params file the reference saved (flax msgpack) resumes in
the port. Tolerances: losses and accuracies within 1e-5 relative and
1e-6 absolute (float32 in both; the optimizers' arithmetic differs in
order), parameters within 1e-5."""
import os
import textwrap

import numpy as np
import pytest

from nnstreamer_tpu.core import MessageType as RMessageType
from nnstreamer_tpu.runtime.parse import parse_launch as r_parse
from nnstreamer_tpu_torch.core import MessageType
from nnstreamer_tpu_torch.runtime.parse import parse_launch

RTOL, ATOL = 2e-4, 1e-6

JAX_CONFIG = textwrap.dedent("""
    import jax.numpy as jnp

    def init(rng, example_inputs):
        x = example_inputs[0]
        return {"w": jnp.zeros((x.shape[-1], 1), jnp.float32),
                "b": jnp.zeros((1,), jnp.float32)}

    def loss_fn(params, inputs, labels):
        x, y = inputs[0], labels[0]
        pred = x @ params["w"] + params["b"]
        loss = jnp.mean((pred - y) ** 2)
        return loss, {"accuracy": jnp.exp(-loss)}
""")

TORCH_CONFIG = textwrap.dedent("""
    import torch

    def init(generator, example_inputs):
        x = example_inputs[0]
        return {"w": torch.zeros((x.shape[-1], 1), device=x.device),
                "b": torch.zeros((1,), device=x.device)}

    def loss_fn(params, inputs, labels):
        x, y = inputs[0], labels[0]
        pred = x @ params["w"] + params["b"]
        loss = torch.mean((pred - y) ** 2)
        return loss, {"accuracy": torch.exp(-loss)}
""")


@pytest.fixture
def configs(tmp_path):
    j, t = tmp_path / "linreg_jax.py", tmp_path / "linreg_torch.py"
    j.write_text(JAX_CONFIG)
    t.write_text(TORCH_CONFIG)
    return str(j), str(t)


def make_dataset(tmp_path, n=64):
    """(x, y = 2·sum(x) + 1) sample pairs through the port's datareposink
    (the reference reads the same files)."""
    rng = np.random.default_rng(0)
    data, meta = str(tmp_path / "d.dat"), str(tmp_path / "d.json")
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,dimensions=3.1,"
        f"types=float32 ! datareposink location={data} json={meta}")
    pipe.play()
    src = pipe.get("in")
    for _ in range(n):
        x = rng.normal(size=3).astype(np.float32)
        src.push_buffer([x, np.array([2 * x.sum() + 1], np.float32)])
    src.end_of_stream()
    pipe.wait(timeout=15)
    pipe.stop()
    return data, meta


def _run(port: bool, line: str, with_backend: bool = False):
    """Run ``line`` in one package; return the completion message's data
    (and the backend's loss/accuracy histories)."""
    parse, mt = (parse_launch, MessageType) if port else (r_parse, RMessageType)
    pipe = parse(line)
    pipe.play()
    msg = pipe.bus.wait_for((mt.ELEMENT, mt.ERROR), timeout=60)
    assert msg is not None and msg.type is mt.ELEMENT, msg
    hist = None
    if with_backend:
        b = pipe.get("t").backend
        hist = (list(b.losses), list(b.accuracies))
    pipe.wait(timeout=30)
    pipe.stop()
    return (dict(msg.data), hist) if with_backend else dict(msg.data)


def _both(configs, tail, with_backend=False, port_extra="accelerator=cpu"):
    jcfg, tcfg = configs
    want = _run(False, tail.format(cfg=jcfg, extra="", who="ref"),
                with_backend)
    got = _run(True, tail.format(cfg=tcfg, extra=port_extra, who="port"),
               with_backend)
    return got, want


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


FIELDS = ("training_loss", "training_accuracy", "validation_loss",
          "validation_accuracy")


@pytest.mark.parametrize("optimizer", ["adam", "sgd", "adamw"])
def test_training_matches_reference_and_saves(tmp_path, configs, optimizer):
    data, meta = make_dataset(tmp_path)
    (got, ghist), (want, whist) = _both(configs, (
        f"datareposrc location={data} json={meta} epochs=8 "
        "! tensor_trainer name=t {extra} model-config={cfg} "
        f"model-save-path={tmp_path}/m.{{who}}.msgpack "
        "num-training-samples=64 epochs=8 "
        f"custom=batch:16,lr:0.1,optimizer:{optimizer}"), with_backend=True)
    assert got["event"] == want["event"] == "training-complete"
    assert got["epochs"] == want["epochs"] == 8
    assert got["samples"] == want["samples"] == 64 * 8
    for f in FIELDS:
        _close(got[f], want[f])
    _close(ghist[0], whist[0])      # per-epoch loss history
    _close(ghist[1], whist[1])      # per-epoch accuracy history
    assert got["model_saved"] == f"{tmp_path}/m.port.msgpack"
    # the port's saved params are flax msgpack: the reference's reader
    # takes them, and they equal the reference's own
    from flax import serialization
    port = serialization.msgpack_restore(open(got["model_saved"], "rb").read())
    ref = serialization.msgpack_restore(open(want["model_saved"], "rb").read())
    for k in ("w", "b"):
        np.testing.assert_allclose(port[k], ref[k], rtol=RTOL, atol=1e-5)


def test_validation_split_matches_reference(tmp_path, configs):
    data, meta = make_dataset(tmp_path, n=80)
    got, want = _both(configs, (
        f"datareposrc location={data} json={meta} epochs=4 "
        "! tensor_trainer name=t {extra} model-config={cfg} "
        "num-training-samples=64 num-validation-samples=16 epochs=4 "
        "custom=batch:16,lr:0.1"))
    assert got["event"] == want["event"] == "training-complete"
    assert got["epochs"] == want["epochs"] == 4
    for f in FIELDS:
        _close(got[f], want[f])
    assert 0.0 < got["validation_loss"] < 2.0


def test_port_resumes_from_the_reference_saved_model(tmp_path, configs):
    """model-load-path: a params file the reference wrote (flax msgpack)
    resumes in the port, and its second run equals the reference's."""
    data, meta = make_dataset(tmp_path)
    jcfg, tcfg = configs
    line = (f"datareposrc location={data} json={meta} epochs=4 "
            "! tensor_trainer {extra} model-config={cfg} {load} "
            "model-save-path={save} num-training-samples=64 epochs=4 "
            "custom=batch:16,lr:0.1")
    first = _run(False, line.format(extra="", cfg=jcfg, load="",
                                    save=tmp_path / "m1.msgpack"))
    load = f"model-load-path={tmp_path}/m1.msgpack"
    want = _run(False, line.format(extra="", cfg=jcfg, load=load,
                                   save=tmp_path / "m2.msgpack"))
    got = _run(True, line.format(extra="accelerator=cpu", cfg=tcfg,
                                 load=load, save=tmp_path / "m2p.msgpack"))
    assert got["training_loss"] < first["training_loss"]
    _close(got["training_loss"], want["training_loss"])


def test_wrong_tensor_count_errors(configs):
    pipe = parse_launch(
        "tensor_src num-buffers=1 dimensions=3 types=float32 "
        f"! tensor_trainer accelerator=cpu model-config={configs[1]} "
        "num-inputs=1 num-labels=1")
    pipe.play()
    msg = pipe.bus.wait_for((MessageType.ERROR,), timeout=10)
    pipe.stop()
    assert msg is not None and "expected 1 inputs" in msg.data["error"]


def test_checkpoint_resume_matches_reference(tmp_path, configs):
    """ckpt_dir: two epochs with a checkpoint each, then a second run to
    epoch 4 resuming from the latest; histories equal the reference's."""
    data, meta = make_dataset(tmp_path)
    jcfg, tcfg = configs

    def train(port, epochs, start_epoch, ckpt_dir):
        cfg, extra = (tcfg, "accelerator=cpu") if port else (jcfg, "")
        return _run(port, (
            f"datareposrc location={data} json={meta} epochs={epochs} "
            f"start-epoch={start_epoch} is-shuffle=true seed=3 "
            f"! tensor_trainer framework=optax {extra} model-config={cfg} "
            f"num-training-samples=64 epochs={epochs} "
            f"custom=batch:16,lr:0.05,ckpt_dir:{ckpt_dir} name=t"),
            with_backend=True)[1][0]

    hist = {}
    for port in (False, True):
        ck = str(tmp_path / f"ck{int(port)}")
        first = train(port, 2, 0, ck)
        second = train(port, 4, 2, ck)
        assert len(first) == 2 and len(second) == 4
        assert second[:2] == first           # history restored
        assert second[-1] < first[-1]
        hist[port] = second
    _close(hist[True], hist[False])
    from nnstreamer_tpu_torch.trainer.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path / "ck1"))
    assert mgr.latest_step() == 4 and mgr.steps() == [2, 3, 4]
    assert sorted(mgr.read_meta(4)) == ["accuracies", "data_epoch",
                                        "epoch_count", "losses"]


def _state(v: float):
    import torch
    return {"w": torch.full((2, 2), v), "b": torch.full((1,), v * 10)}


def test_checkpoint_save_restore_roundtrip(tmp_path):
    from nnstreamer_tpu_torch.trainer.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, _state(1.0), {"epoch_count": 1})
    mgr.save(2, _state(2.0), {"epoch_count": 2, "losses": [0.5, 0.25]})
    assert mgr.steps() == [1, 2]
    state, meta = mgr.restore()
    assert meta["epoch_count"] == 2 and meta["losses"] == [0.5, 0.25]
    np.testing.assert_allclose(state["w"].numpy(), 2.0)
    state1, _ = mgr.restore(step=1)
    np.testing.assert_allclose(state1["b"].numpy(), 10.0)


def test_checkpoint_retention(tmp_path):
    from nnstreamer_tpu_torch.trainer.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(float(s)), {})
    assert mgr.steps() == [3, 4]


def test_checkpoint_partial_write_ignored(tmp_path):
    from nnstreamer_tpu_torch.trainer.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, _state(1.0), {})
    os.makedirs(str(tmp_path / "ck" / "step_9"))        # a crashed write
    os.makedirs(str(tmp_path / "ck" / "step_7.tmp"))
    assert mgr.latest_step() == 1


def test_reference_trainer_names_resolve_to_the_torch_trainer():
    from nnstreamer_tpu_torch.registry.elements import element_factories
    from nnstreamer_tpu_torch.registry.subplugin import SubpluginKind, get, names
    from nnstreamer_tpu_torch.trainer.torch_trainer import TorchTrainer

    for name in ("optax", "jax", "flax", "torch"):
        assert get(SubpluginKind.TRAINER, name) is TorchTrainer
    assert names(SubpluginKind.TRAINER) == ["torch"]
    assert "tensor_trainer" in element_factories()


def test_ready_to_complete_finishes_with_the_data_it_has(tmp_path, configs):
    """The one-way switch ends training after the frames already pushed:
    8 of an epoch of 16 make one (short) epoch."""
    import time

    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,num_tensors=2,"
        "dimensions=3.1,types=float32.float32 ! tensor_trainer name=t "
        f"accelerator=cpu model-config={configs[1]} epochs=100 "
        "num-training-samples=16 custom=batch:4,lr:0.1")
    pipe.play()
    try:
        rng = np.random.default_rng(1)
        for _ in range(8):
            x = rng.normal(size=3).astype(np.float32)
            pipe.get("in").push_buffer([x, np.array([x.sum()], np.float32)])
        deadline = time.monotonic() + 30
        while pipe.get("t")._pushed < 8 and time.monotonic() < deadline:
            time.sleep(0.01)
        pipe.get("t").set_property("ready-to-complete", True)
        backend = pipe.get("t").backend
        assert backend.wait_complete(timeout=30)
        assert backend.stats.epoch_count == 1
        assert len(backend.losses) == 1
    finally:
        pipe.stop()
