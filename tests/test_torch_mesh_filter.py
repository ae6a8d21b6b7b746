"""The torch backend's sharded invoke (``tensor_filter custom=mesh:...``)
against nnstreamer_tpu's (mirrors ``tests/test_mesh_filter.py``).

The port runs SPMD: a spawned gloo world of 4 processes, every rank
running the same lines on the same frames, each computing its dp block
and all-gathering the outputs, so every rank's sink holds the global
batch. The reference meshes 4 of its 8 virtual CPU devices. The world's
cases: dp=4 (against the reference on its own weights, and with each
rank shown its block of 2 rows), ``auto``, a batch dp does not divide, a
bad spec, ``device:`` with ``mesh:``, specs larger and smaller than the
world, a query server whose filter is meshed, and a meshed filter into
the batched labeling decoder. In this process (no world up): a ``mesh:``
spec is an error naming ``init_multihost``, on the filter and on
``tensor_generate``.

Float outputs within rtol 1e-5 (the port's rows are the same products as
its unmeshed run; the reference orders its FMAs by shard); labels exact.
"""
import numpy as np
import pytest

from test_torch_mesh_serving import spawn_world

WORKER = r'''
import json, os, sys, time
sys.path.insert(0, os.environ["NNS_REPO"])
for name in ("jax", "jaxlib", "flax", "optax", "nnstreamer_tpu"):
    sys.modules[name] = None
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from nnstreamer_tpu_torch.backends.torch_backend import make_builtin
from nnstreamer_tpu_torch.core import MessageType
from nnstreamer_tpu_torch.models.convert import builtin_params_from_jax
from nnstreamer_tpu_torch.parallel import init_multihost
from nnstreamer_tpu_torch.runtime.parse import parse_launch

job, data_path, out_dir = sys.argv[1], sys.argv[2], sys.argv[3]
data = dict(np.load(data_path, allow_pickle=True))
assert init_multihost()
rank = dist.get_rank()
out, arrays = {}, {}


class Seen:
    """The reference's matmul on its own weights, recording the batch
    each call gets."""

    def __init__(self):
        self.fn = make_builtin("builtin://matmul?n=64", weights=
                               builtin_params_from_jax(
                                   "matmul", {"w": data["w"]}, "cpu"))
        self.rows = []

    def __call__(self, x):
        self.rows.append(int(x.shape[0]))
        return self.fn(x)

    def output_info(self, in_info):
        return self.fn.output_info(in_info)


mm_ref = Seen()


def run(line, sink="out"):
    pipe = parse_launch(line)
    got = []
    pipe.get(sink).connect(lambda b: got.append(b.as_numpy()))
    pipe.play()
    msg = pipe.wait(timeout=60)
    mesh = pipe.get("f").backend_mesh
    pipe.stop()
    assert msg is not None and msg.type is MessageType.EOS, msg
    return got, mesh


def error_of(custom):
    pipe = parse_launch(
        "tensor_src num-buffers=1 dimensions=4 types=float32 "
        "! tensor_filter framework=torch accelerator=cpu "
        f"model=builtin://passthrough custom={custom} name=f "
        "! tensor_sink name=out")
    pipe.play()
    msg = pipe.bus.wait_for((MessageType.ERROR,), timeout=30)
    pipe.stop()
    return None if msg is None else str(msg.data.get("error", ""))


def first(got):
    return [np.asarray(b.tensors[0]) for b in got]


COUNTER = ("tensor_src num-buffers={n} dimensions={dims} types=float32 "
           "pattern=counter ! tensor_aggregator frames-out={b} "
           "frames-dim=0 concat=true ! queue max-size-buffers=4 "
           "! tensor_filter framework=torch accelerator=cpu model={m} "
           "custom={c} name=f ! tensor_sink name=out max-stored=8")
if job == "filter4":
    got, mesh = run(COUNTER.format(n=16, dims="64:1", b=8,
                                   m="__main__:mm_ref", c="mesh:dp=4"))
    out["dp4-mesh"] = [list(mesh.mesh_dim_names), int(mesh.size())]
    out["dp4-rows"] = mm_ref.rows
    for i, o in enumerate(first(got)):
        arrays[f"dp4-{i}"] = o
    got, _ = run(COUNTER.format(n=16, dims="64:1", b=8,
                                m="builtin://matmul", c="mesh:dp=4"))
    got1, _ = run(COUNTER.format(n=16, dims="64:1", b=8,
                                 m="builtin://matmul", c="max_signatures:8"))
    out["matmul-meshed-vs-one"] = max(
        float(np.abs(a - b).max()) for a, b in zip(first(got), first(got1)))
    got, mesh = run(COUNTER.format(n=8, dims="16", b=8,
                                   m="builtin://scaler?factor=3",
                                   c="mesh:auto"))
    out["auto-mesh"] = int(mesh.size())
    arrays["auto"] = first(got)[0]
    got, mesh = run(COUNTER.format(n=12, dims="8:1", b=6,
                                   m="builtin://scaler?factor=2",
                                   c="mesh:dp=4"))
    out["indivisible-mesh"] = int(mesh.size())
    for i, o in enumerate(first(got)):
        arrays[f"indivisible-{i}"] = o
    for name, custom in (("bad", "mesh:tp=4"),
                         ("pin", "device:2,mesh:dp=4"),
                         ("over", "mesh:dp=5"), ("under", "mesh:dp=2")):
        out[f"err-{name}"] = error_of(custom)

    server = parse_launch(
        "tensor_query_serversrc name=ssrc id=40 port=0 "
        "caps=other/tensors,format=static,dimensions=16:8,types=float32 "
        "! tensor_filter framework=torch accelerator=cpu "
        "model=builtin://scaler?factor=2 custom=mesh:dp=4 name=f "
        "! tensor_query_serversink id=40")
    server.play()
    ssrc = server.get("ssrc")
    deadline = time.monotonic() + 10
    while ssrc.bound_port == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    client = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,"
        "dimensions=16:8,types=float32 "
        f"! tensor_query_client host=127.0.0.1 port={ssrc.bound_port} "
        "! tensor_sink name=out max-stored=4")
    answers = []
    client.get("out").connect(
        lambda b: answers.append(np.asarray(b.as_numpy().tensors[0])))
    client.play()
    x = np.arange(128, dtype=np.float32).reshape(8, 16)
    for _ in range(2):
        client.get("in").push_buffer(x)
    deadline = time.monotonic() + 60
    while len(answers) < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    client.stop()
    out["query-mesh"] = int(server.get("f").backend_mesh.size())
    server.stop()
    for i, a in enumerate(answers):
        arrays[f"query-{i}"] = a

    labels = os.path.join(out_dir, f"labels{rank}.txt")
    with open(labels, "w") as fh:
        fh.write("\n".join(f"c{i}" for i in range(64)))
    line = ("tensor_src num-buffers=16 dimensions=64:1 types=float32 "
            "pattern=random seed=5 "
            "! tensor_aggregator frames-out=8 frames-dim=0 concat=true "
            "! tensor_filter framework=torch accelerator=cpu "
            "model=builtin://scaler?factor=2 custom={c} name=f "
            f"! tensor_decoder mode=image_labeling option1={labels} "
            "frames-in=8 ! tensor_sink name=out max-stored=64")
    got, _ = run(line.format(c="mesh:dp=4"))
    got1, _ = run(line.format(c="max_signatures:8"))
    out["labels-mesh"] = [b.meta["label_index"] for b in got]
    out["labels-one"] = [b.meta["label_index"] for b in got1]
dist.barrier()
with open(os.path.join(out_dir, f"out{rank}.json"), "w") as fh:
    json.dump(out, fh)
if arrays and rank == 0:
    np.savez(os.path.join(out_dir, "arrays.npz"), **arrays)
dist.destroy_process_group()
'''


def _ref_run(launch):
    from nnstreamer_tpu.runtime.parse import parse_launch

    pipe = parse_launch(launch)
    got = []
    pipe.get("out").connect(got.append)
    pipe.play()
    pipe.wait(timeout=60)
    pipe.stop()
    return [np.asarray(b.tensors[0]) for b in got]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    w = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (64, 64),
                                     jnp.float32))
    return spawn_world(tmp_path_factory.mktemp("filter4"), WORKER,
                       "filter4", 4, dict(w=w))


def test_mesh_dp4_matches_the_reference_and_shards(world4):
    outs, a = world4
    want = _ref_run(
        "tensor_src num-buffers=16 dimensions=64:1 types=float32 "
        "pattern=counter "
        "! tensor_aggregator frames-out=8 frames-dim=0 concat=true "
        "! queue max-size-buffers=4 "
        "! tensor_filter framework=jax model=builtin://matmul "
        "custom=mesh:dp=4 ! tensor_sink name=out max-stored=4")
    assert len(want) == 2
    for i, wv in enumerate(want):
        np.testing.assert_allclose(a[f"dp4-{i}"], wv, rtol=1e-5, atol=1e-5)
    for o in outs:
        assert o["dp4-mesh"] == [["dp"], 4]
        # each rank ran its block of 2 rows of every batch of 8
        assert o["dp4-rows"] == [2, 2]
        assert o["matmul-meshed-vs-one"] <= 1e-5


def test_mesh_auto_uses_the_whole_world(world4):
    outs, a = world4
    assert all(o["auto-mesh"] == 4 for o in outs)
    # eight 16-value frames concatenated on dim 0: 128 values
    want = np.repeat(np.arange(8, dtype=np.float32) * 3, 16)
    np.testing.assert_array_equal(a["auto"], want)


def test_mesh_indivisible_batch_falls_back_unsharded(world4):
    outs, a = world4
    assert all(o["indivisible-mesh"] == 4 for o in outs)
    first = a["indivisible-0"]
    assert first.shape == (6, 8)
    np.testing.assert_allclose(first[0], 0.0)
    np.testing.assert_allclose(first[1], 2.0)
    np.testing.assert_allclose(a["indivisible-1"][0], 12.0)


def test_mesh_spec_errors(world4):
    outs, _ = world4
    for o in outs:
        assert "mesh" in o["err-bad"].lower()
        assert "mutually exclusive" in o["err-pin"]
        assert "out of range" in o["err-over"]
        assert "needs 5 ranks" in o["err-over"]
        assert "out of range" in o["err-under"]
        assert "the world has 4" in o["err-under"]


def test_query_server_with_a_meshed_filter(world4):
    outs, a = world4
    x = np.arange(128, dtype=np.float32).reshape(8, 16)
    for i in range(2):
        np.testing.assert_allclose(a[f"query-{i}"], x * 2)
    assert all(o["query-mesh"] == 4 for o in outs)


def test_meshed_filter_into_the_batched_labeling_decoder(world4):
    outs, _ = world4
    for o in outs:
        assert len(o["labels-mesh"]) == 16
        assert o["labels-mesh"] == o["labels-one"]


def test_mesh_without_a_process_group_names_init_multihost():
    import torch.distributed as dist

    from nnstreamer_tpu_torch.backends.torch_backend import parse_mesh_spec
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="init_multihost"):
        parse_mesh_spec("dp=1")
    with pytest.raises(ValueError, match="expected 'dp=<N>'"):
        parse_mesh_spec("tp=4")
    # against a world size given, the spec's count is checked first
    with pytest.raises(ValueError, match="needs 6 ranks, out of range"):
        parse_mesh_spec("2x3", 4)
    for line in (
            "tensor_src num-buffers=1 dimensions=4 types=float32 "
            "! tensor_filter framework=torch accelerator=cpu "
            "model=builtin://passthrough custom=mesh:dp=1 "
            "! tensor_sink name=out",
            "appsrc name=in caps=other/tensors,format=static,"
            "dimensions=6:4,types=int32 ! tensor_generate accelerator=cpu "
            "model=nnstreamer_tpu_torch.models.lm_serving:tiny mesh=1x1 "
            "! tensor_sink name=out"):
        pipe = parse_launch(line)
        pipe.play()
        if "appsrc" in line:
            pipe.get("in").push_buffer(np.zeros((4, 6), np.int32))
        msg = pipe.bus.wait_for((MessageType.ERROR,), timeout=30)
        pipe.stop()
        assert msg is not None
        err = str(msg.data.get("error", ""))
        assert "init_multihost" in err and "NNS_COORD" in err
