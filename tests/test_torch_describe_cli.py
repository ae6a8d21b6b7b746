"""The port's declarative pipeline format and CLI verbs (``launch``,
``inspect``, ``convert``, ``codegen``), mirroring the reference's
``tests/test_describe_cli.py`` case for case, plus parity: ``convert``
output byte-equal to nnstreamer_tpu's, ``inspect``'s element list equal,
and ``launch``'s exit codes 0/1/2."""
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nnstreamer_tpu.__main__ import main as ref_cli
from nnstreamer_tpu_torch.__main__ import main as port_cli
from nnstreamer_tpu_torch.runtime.describe import (
    description_to_launch,
    launch_to_description,
    load_pipeline_file,
    pipeline_from_description,
)

ROOT = Path(__file__).resolve().parent.parent


class TestDescription:
    def test_linear_description_runs(self):
        desc = {
            "elements": [
                {"factory": "tensor_src", "name": "src",
                 "props": {"num-buffers": 3, "dimensions": "4", "pattern": "ones"}},
                {"factory": "tensor_transform", "name": "t",
                 "props": {"mode": "arithmetic", "option": "mul:2",
                           "accelerator": "cpu"}},
                {"factory": "tensor_sink", "name": "out"},
            ],
        }
        pipe = pipeline_from_description(desc)
        got = []
        pipe.get("out").connect(lambda b: got.append(b.as_numpy().tensors[0]))
        pipe.run(timeout=20)
        assert len(got) == 3
        np.testing.assert_allclose(got[0], 2.0)

    def test_explicit_links_and_caps_entry(self):
        desc = {
            "elements": [
                {"factory": "tensor_src", "name": "src",
                 "props": {"num-buffers": 1, "dimensions": "4", "types": "float32"}},
                {"caps": "other/tensors,types=float32", "name": "cf"},
                {"factory": "tensor_sink", "name": "out"},
            ],
            "links": [["src", "cf"], ["cf", "out"]],
        }
        launch = description_to_launch(desc)
        assert "other/tensors,types=float32" in launch
        pipe = pipeline_from_description(desc)
        got = []
        pipe.get("out").connect(got.append)
        pipe.run(timeout=20)
        assert len(got) == 1

    def test_branching_description(self):
        desc = {
            "elements": [
                {"factory": "tensor_src", "name": "src",
                 "props": {"num-buffers": 2, "dimensions": "4"}},
                {"factory": "tee", "name": "t"},
                {"factory": "tensor_sink", "name": "a"},
                {"factory": "tensor_sink", "name": "b"},
            ],
            "links": [["src", "t"], ["t", "a"], ["t", "b"]],
        }
        pipe = pipeline_from_description(desc)
        got_a, got_b = [], []
        pipe.get("a").connect(got_a.append)
        pipe.get("b").connect(got_b.append)
        pipe.run(timeout=20)
        assert len(got_a) == 2 and len(got_b) == 2

    def test_roundtrip_launch_desc_launch(self):
        launch = ("tensor_src name=src num-buffers=2 dimensions=4 "
                  "! tensor_transform name=t mode=arithmetic option=add:1 "
                  "accelerator=cpu ! tensor_sink name=out")
        desc = launch_to_description(launch)
        names = {e["name"] for e in desc["elements"]}
        assert {"src", "t", "out"} <= names
        t = next(e for e in desc["elements"] if e["name"] == "t")
        assert t["props"]["mode"] == "arithmetic"
        pipe = pipeline_from_description(desc)
        got = []
        pipe.get("out").connect(lambda b: got.append(b.as_numpy().tensors[0]))
        pipe.run(timeout=20)
        assert len(got) == 2 and got[0][0] == 1.0

    def test_json_file_loading(self, tmp_path):
        desc = {"elements": [
            {"factory": "tensor_src", "props": {"num-buffers": 1, "dimensions": "2"}},
            {"factory": "tensor_sink", "name": "out"},
        ]}
        f = tmp_path / "p.json"
        f.write_text(json.dumps(desc))
        pipe = load_pipeline_file(str(f))
        got = []
        pipe.get("out").connect(got.append)
        pipe.run(timeout=20)
        assert len(got) == 1

    def test_unknown_link_target_raises(self):
        with pytest.raises(ValueError, match="unknown element"):
            description_to_launch({
                "elements": [{"factory": "tensor_src", "name": "a"}],
                "links": [["a", "ghost"]],
            })


def _cli(*argv, timeout=120, env=None):
    return subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch", *argv],
        capture_output=True, text=True, timeout=timeout, cwd=str(ROOT),
        env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin",
             "HOME": os.environ.get("HOME", "/tmp"), **(env or {})},
    )


class TestCLI:
    def test_inspect_lists_elements(self):
        r = _cli("inspect")
        assert r.returncode == 0
        assert "tensor_filter" in r.stdout and "mqttsrc" in r.stdout

    def test_inspect_one_element(self):
        r = _cli("inspect", "tensor_aggregator")
        assert r.returncode == 0
        assert "frames-out" in r.stdout or "frames_out" in r.stdout

    def test_launch_runs_pipeline(self):
        r = _cli("launch",
                 "tensor_src num-buffers=2 dimensions=3 ! tensor_sink",
                 "--timeout", "30")
        assert r.returncode == 0, r.stderr
        assert "EOS" in r.stdout

    def test_launch_error_exit_code(self):
        r = _cli("launch", "tensor_src_iio device=ghost ! tensor_sink",
                 "--timeout", "30")
        assert r.returncode == 1
        assert "ERROR" in r.stderr

    def test_convert_both_directions(self, tmp_path):
        r = _cli("convert", "tensor_src num-buffers=1 dimensions=2 ! tensor_sink")
        assert r.returncode == 0
        desc = json.loads(r.stdout)
        assert len(desc["elements"]) == 2
        f = tmp_path / "p.json"
        f.write_text(r.stdout)
        r2 = _cli("convert", str(f))
        assert r2.returncode == 0
        assert "tensor_src" in r2.stdout and "!" in r2.stdout

    def test_codegen_filter_skeleton_is_loadable(self, tmp_path):
        out = tmp_path / "custom.py"
        r = _cli("codegen", "filter", str(out))
        assert r.returncode == 0
        text = out.read_text()
        assert "framework=torch" in text and "import torch" in text
        # the generated skeleton runs as a model file
        from nnstreamer_tpu_torch.runtime.parse import parse_launch

        pipe = parse_launch(
            f"tensor_src num-buffers=1 dimensions=4 types=float32 pattern=ones "
            f"! tensor_filter framework=torch accelerator=cpu model={out} "
            "! tensor_sink name=o")
        got = []
        pipe.get("o").connect(lambda b: got.append(b.as_numpy().tensors[0]))
        pipe.run(timeout=30)
        np.testing.assert_allclose(got[0], 1.0)


# ---------------------------------------------------------------------------
# parity with nnstreamer_tpu's verbs, in this process
# ---------------------------------------------------------------------------

def _out(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    return rc, buf.getvalue()


# every element named: an unnamed one takes its package's running
# counter, which differs between the two packages in one process
LINES = [
    "tensor_src name=s num-buffers=1 dimensions=2 ! tensor_sink name=o",
    "tensor_src name=src num-buffers=2 dimensions=4 ! tensor_transform "
    "name=t mode=arithmetic option=add:1 ! queue name=q ! tensor_sink "
    "name=out",
    "tensor_src name=s num-buffers=2 dimensions=4 ! tee name=t t. ! queue "
    "name=q1 ! tensor_sink name=a t. ! queue name=q2 ! tensor_sink name=b",
]


@pytest.mark.parametrize("line", LINES)
def test_convert_is_byte_equal_to_the_references(tmp_path, line):
    rc, port = _out(port_cli, ["convert", line])
    ref_rc, ref = _out(ref_cli, ["convert", line])
    assert rc == ref_rc == 0 and port == ref
    f = tmp_path / "p.json"
    f.write_text(port)
    assert _out(port_cli, ["convert", str(f)]) == \
        _out(ref_cli, ["convert", str(f)])
    for flag in ("--pbtxt",):
        rc, port = _out(port_cli, ["convert", flag, line])
        assert (rc, port) == _out(ref_cli, ["convert", flag, line])
        pb = tmp_path / "p.pbtxt"
        pb.write_text(port)
        assert _out(port_cli, ["convert", "--from-pbtxt", str(pb)]) == \
            _out(ref_cli, ["convert", "--from-pbtxt", str(pb)])


def test_inspect_element_list_equals_the_references():
    rc, port = _out(port_cli, ["inspect"])
    ref_rc, ref = _out(ref_cli, ["inspect"])
    assert rc == ref_rc == 0
    assert port.split() == ref.split()


@pytest.mark.parametrize("argv,rc", [
    (["launch", "tensor_src num-buffers=2 dimensions=3 ! tensor_sink",
      "--timeout", "30", "--latency"], 0),
    (["launch", "tensor_src_iio device=ghost ! tensor_sink",
      "--timeout", "30"], 1),
    (["launch", "tensor_src dimensions=3 ! tensor_sink", "--timeout",
      "0.2"], 2),
])
def test_launch_exit_codes_equal_the_references(argv, rc):
    port_rc, out = _out(port_cli, argv)
    assert port_rc == _out(ref_cli, argv)[0] == rc
    if "--latency" in argv:
        assert "latency_s" in json.loads(out.splitlines()[0])


def test_launch_place_kill_switch(tmp_path, monkeypatch):
    # NNS_NO_PLACE wins over --place on both input forms
    plan = tmp_path / "plan.json"
    plan.write_text("not json")   # never read under the kill switch
    monkeypatch.setenv("NNS_NO_PLACE", "1")
    rc, _ = _out(port_cli, ["launch", "tensor_src num-buffers=1 dimensions=2 "
                            "! tensor_sink", "--place", str(plan),
                            "--timeout", "30"])
    assert rc == 0
