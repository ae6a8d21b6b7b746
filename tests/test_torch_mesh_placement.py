"""The planner-assignment surface of the port's pipeline parallelism
(``parallel/pipeline.py::mesh_from_assignment`` and
``make_pipeline(assignment=)``) on a spawned gloo world of 2, against
nnstreamer_tpu's (mirrors ``tests/test_placement.py:405-440``): the
assignment's validation errors, the mesh's rank order, and a pipeline
built from an assignment equal to one over a hand-built mesh and to the
reference's (within 1e-5 relative: each stage is one float32 product and
a tanh on every side).
"""
import numpy as np
import pytest

from test_torch_mesh_serving import spawn_world

WORKER = r'''
import json, os, sys
sys.path.insert(0, os.environ["NNS_REPO"])
for name in ("jax", "jaxlib", "flax", "optax", "nnstreamer_tpu"):
    sys.modules[name] = None
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from nnstreamer_tpu_torch.parallel import init_multihost, make_mesh
from nnstreamer_tpu_torch.parallel.pipeline import (
    make_pipeline, mesh_from_assignment, stack_stage_params)

job, data_path, out_dir = sys.argv[1], sys.argv[2], sys.argv[3]
data = dict(np.load(data_path, allow_pickle=True))
assert init_multihost()
rank = dist.get_rank()
out, arrays = {}, {}


def message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


out["reuse"] = message(lambda: mesh_from_assignment([0, 0], 2))
out["range"] = message(lambda: mesh_from_assignment([0, 99], 2))
out["stages"] = message(lambda: mesh_from_assignment([0], 2))
out["order"] = mesh_from_assignment([1, 0], 2).mesh.tolist()


def stage_fn(w, x):
    return torch.tanh(x @ w)


stacked = stack_stage_params([torch.from_numpy(w) for w in data["w"]])
xs = torch.from_numpy(data["xs"])
hand = make_pipeline(stage_fn, 2, make_mesh(None, {"pp": 2}))
auto = make_pipeline(stage_fn, 2, assignment=[0, 1])
arrays["hand"] = hand(stacked, xs).numpy()
arrays["auto"] = auto(stacked, xs).numpy()
dist.barrier()
with open(os.path.join(out_dir, f"out{rank}.json"), "w") as fh:
    json.dump(out, fh)
if rank == 0:
    np.savez(os.path.join(out_dir, "arrays.npz"), **arrays)
dist.destroy_process_group()
'''


def test_assignment_surfaces_match_the_reference(tmp_path):
    import jax.numpy as jnp

    from nnstreamer_tpu.parallel.pipeline import (
        make_pipeline,
        mesh_from_assignment,
        stack_stage_params,
    )

    rng = np.random.default_rng(0)
    w = np.stack([rng.normal(size=(4, 4)).astype(np.float32)
                  for _ in range(2)])
    xs = rng.normal(size=(2, 3, 4)).astype(np.float32)
    outs, arrays = spawn_world(tmp_path, WORKER, "placement", 2,
                               dict(w=w, xs=xs))
    for o in outs:
        for key, match in (("reuse", "reuses a device"),
                           ("range", "out of range"), ("stages", "stages")):
            with pytest.raises(ValueError, match=match):
                mesh_from_assignment(
                    {"reuse": [0, 0], "range": [0, 99],
                     "stages": [0]}[key], 2)
            assert o[key] is not None and match in o[key], (key, o[key])
        assert o["order"] == [1, 0]
    assert [d.id for d in mesh_from_assignment([1, 0], 2).devices.flat] \
        == [1, 0]
    want = make_pipeline(lambda p, x: jnp.tanh(x @ p), 2, assignment=[0, 1])(
        stack_stage_params([jnp.asarray(x) for x in w]), jnp.asarray(xs))
    np.testing.assert_allclose(arrays["auto"], arrays["hand"], rtol=1e-5)
    np.testing.assert_allclose(arrays["auto"], np.asarray(want), rtol=1e-5,
                               atol=1e-6)
