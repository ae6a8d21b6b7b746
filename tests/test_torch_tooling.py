"""The port's tooling plane beside nnstreamer_tpu's: ``Pipeline(validate=)``
(warn-only lint at play, mirroring the reference's
``tests/test_lint.py`` TestWiring), NNL013 and NNL014 on the same lines,
the ``obs`` verbs (in this process and against a ``ControlServer``), the
profile artifact's kernel section, and ``entry.py``."""
import contextlib
import io
import json
import logging
import os

import numpy as np
import pytest

from nnstreamer_tpu.analysis import lint_launch as ref_lint_launch
from nnstreamer_tpu.analysis import lint_pipeline as ref_lint_pipeline
from nnstreamer_tpu.obs import profile as jprofile
from nnstreamer_tpu.runtime.parse import parse_launch as ref_parse
from nnstreamer_tpu.runtime.pipeline import Pipeline as RefPipeline
from nnstreamer_tpu_torch import entry
from nnstreamer_tpu_torch.__main__ import _follow_flight
from nnstreamer_tpu_torch.__main__ import main as cli
from nnstreamer_tpu_torch.analysis import Severity, lint_launch, lint_pipeline
from nnstreamer_tpu_torch.obs import profile as tprofile
from nnstreamer_tpu_torch.runtime.parse import parse_launch
from nnstreamer_tpu_torch.runtime.pipeline import Pipeline

TEE = "tensor_src num-buffers=2 ! tee name=t t. ! tensor_sink"
SRC = ("tensor_src name=src num-buffers={n} dimensions=8 types=float32 "
       "pattern=counter ")
ADD = "tensor_transform name={name} mode=arithmetic option=add:1 {acc}"
SCALER = ("tensor_filter name={name} framework={fw} "
          "model=builtin://scaler?factor=2 {acc}")
FUSED = (SRC + "! " + ADD.replace("{name}", "a") + "! "
         + SCALER.replace("{name}", "f") + "! tensor_sink name=out")


def port_line(line: str, n: int = 4) -> str:
    return line.format(n=n, fw="torch", acc="accelerator=cpu ")


def ref_line(line: str, n: int = 4) -> str:
    return line.format(n=n, fw="jax", acc="")


def _warned(caplog, logger: str, level=logging.WARNING):
    return sorted({r.getMessage().split(": ")[1].split()[0]
                   for r in caplog.records
                   if r.name == logger and r.levelno == level
                   and "NNL" in r.getMessage()})


# ---------------------------------------------------------------------------
# Pipeline(validate=)
# ---------------------------------------------------------------------------

def test_pipeline_validate_warn_only(caplog):
    p = Pipeline(validate=True)
    parse_launch(TEE, pipeline=p)
    with caplog.at_level(logging.WARNING, logger="nnstreamer_tpu_torch"):
        msg = p.run(timeout=30)
    assert msg.type.name == "EOS"   # warn-only: the pipeline still ran
    got = _warned(caplog, "nnstreamer_tpu_torch")
    assert "NNL007" in got
    caplog.clear()
    r = RefPipeline(validate=True)
    ref_parse(TEE, pipeline=r)
    with caplog.at_level(logging.WARNING, logger="nnstreamer_tpu"):
        assert r.run(timeout=30).type.name == "EOS"
    assert got == _warned(caplog, "nnstreamer_tpu")


def test_pipeline_validate_off_by_default(caplog):
    p = Pipeline()
    parse_launch(TEE, pipeline=p)
    with caplog.at_level(logging.WARNING, logger="nnstreamer_tpu_torch"):
        p.run(timeout=30)
    assert not any("NNL007" in r.message for r in caplog.records)


def test_validate_logs_the_fusion_plan_at_info(caplog):
    p = Pipeline(validate=True)
    parse_launch(port_line(FUSED), pipeline=p)
    with caplog.at_level(logging.INFO, logger="nnstreamer_tpu_torch"):
        assert p.run(timeout=30).type.name == "EOS"
    plans = [r for r in caplog.records if "NNL013" in r.getMessage()]
    assert [r.levelno for r in plans] == [logging.INFO]
    assert "fused device segment: a -> f" in plans[0].getMessage()
    assert [[el.name for el in s.elements] for s in p.fused_segments] == \
        [["a", "f"]]


def test_a_lint_that_raises_never_blocks_play(caplog, monkeypatch):
    from nnstreamer_tpu_torch import analysis

    def boom(pipeline):
        raise RuntimeError("lint exploded")
    monkeypatch.setattr(analysis, "lint_pipeline", boom)
    p = Pipeline(validate=True)
    parse_launch(TEE, pipeline=p)
    with caplog.at_level(logging.ERROR, logger="nnstreamer_tpu_torch"):
        assert p.run(timeout=30).type.name == "EOS"
    assert any("static validation failed" in r.getMessage()
               for r in caplog.records)


# ---------------------------------------------------------------------------
# NNL013 / NNL014 against the reference on the same line
# ---------------------------------------------------------------------------

def _nnl(diags, rule):
    return [(d.rule, d.severity.value, d.location, d.message.split(" (")[0])
            for d in diags if d.rule == rule]


@pytest.mark.parametrize("line", [
    FUSED,
    SRC + "! " + ADD.replace("{name}", "a") + "! "
    + ADD.replace("{name}", "b") + "! queue name=q ! "
    + SCALER.replace("{name}", "f") + "! "
    + SCALER.replace("{name}", "g") + "! tensor_sink name=out",
])
def test_nnl013_equals_the_references(line):
    got = _nnl(lint_launch(port_line(line)), "NNL013")
    assert got and got == _nnl(ref_lint_launch(ref_line(line)), "NNL013")
    # fusion off: no plan in either
    assert not _nnl(lint_pipeline(parse_launch(port_line(line), fuse=False)),
                    "NNL013")
    assert not _nnl(ref_lint_pipeline(ref_parse(ref_line(line), fuse=False)),
                    "NNL013")


# the reference's tests/test_placement.py line: 3 device stages over 2
# queues, two fused segments and one singleton
MULTI = (SRC + "! " + ADD.replace("{name}", "a") + "! "
         + ADD.replace("{name}", "b").replace("add:1", "mul:2")
         + "! queue name=q0 max-size-buffers=16 ! "
         + ADD.replace("{name}", "c") + "! " + SCALER.replace("{name}", "f")
         + "! queue name=q1 max-size-buffers=16 ! "
         + SCALER.replace("{name}", "g") + "! tensor_sink name=out "
         "max-stored=1")


def test_nnl014_equals_the_references(tmp_path, monkeypatch):
    """A calibrated run of the same three-stage line persists an artifact
    in each package's store; an unplaced lint of the line then hints
    NNL014 in both, and a placed one in neither."""
    import torch

    from nnstreamer_tpu_torch.runtime.placement import Planner

    devices = [torch.device("cpu", i) for i in range(8)]
    orig = Planner.devices.fget

    def farm(self):   # the port's planner sees 8 CPU devices, as the
        if self._devices is None:    # reference sees its 8 virtual ones
            self._devices = list(devices)
        return orig(self)
    monkeypatch.setattr(Planner, "devices", property(farm))
    for side, parse, mk in (("ref", ref_parse, ref_line),
                            ("port", parse_launch, port_line)):
        monkeypatch.setenv("NNS_PROFILE_STORE", str(tmp_path / side))
        parse(mk(MULTI, 120), place="auto").run(timeout=60)
        assert os.listdir(tmp_path / side)
    monkeypatch.setenv("NNS_PROFILE_STORE", str(tmp_path / "port"))
    got = lint_pipeline(parse_launch(port_line(MULTI, 80)))
    monkeypatch.setenv("NNS_PROFILE_STORE", str(tmp_path / "ref"))
    want = ref_lint_pipeline(ref_parse(ref_line(MULTI, 80)))
    hits = _nnl(got, "NNL014")
    assert len(hits) == 1 and hits[0][1] == Severity.INFO.value
    assert [h[:3] for h in hits] == [h[:3] for h in _nnl(want, "NNL014")]
    assert "better plan is available" in [d.message for d in got
                                           if d.rule == "NNL014"][0]
    monkeypatch.setenv("NNS_PROFILE_STORE", str(tmp_path / "port"))
    assert not _nnl(lint_pipeline(parse_launch(port_line(MULTI, 80),
                                               place="auto")), "NNL014")


# ---------------------------------------------------------------------------
# the obs verbs
# ---------------------------------------------------------------------------

def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(list(argv))
    return rc, buf.getvalue()


LM_LINE = ("appsrc name=in caps=other/tensors,format=static,dimensions=6:2,"
           "types=int32 ! tensor_generate model=nnstreamer_tpu_torch.models."
           "lm_serving:tiny steps=3 accelerator=cpu ! tensor_sink name=out")


def test_obs_profile_launch_merge_diff(tmp_path):
    a, b, m = (str(tmp_path / f"{k}.json") for k in "abm")
    line = port_line(FUSED, 6)
    for out in (a, b):
        rc, text = _run(["obs", "profile", "--launch", line, "--out", out])
        assert rc == 0 and f"wrote profile artifact {out}" in text
    art = json.loads(open(a).read())
    assert art["kind"] == "nns-profile" and art["entries"]["element"]
    # no hand kernel runs on the CPU: the artifact has no kernels section,
    # so its JSON is the reference's shape
    assert "kernels" not in art
    assert _run(["obs", "profile", "--merge", a, b])[0] == 2
    rc, text = _run(["obs", "profile", "--merge", a, b, "--out", m])
    assert rc == 0
    merged = tprofile.ProfileArtifact.load(m)
    arts = [tprofile.ProfileArtifact.load(p) for p in (a, b)]
    for name, e in arts[0].entries["element"].items():
        assert merged.entries["element"][name]["count"] == \
            e["count"] + arts[1].entries["element"][name]["count"]
    # the reference loads the port's merged artifact
    assert jprofile.ProfileArtifact.load(m).key == merged.key
    rc, text = _run(["obs", "profile", "--diff", a, b])
    diff = json.loads(text)
    assert rc == 0 and all("delta_p50_ms" in row
                           for row in diff["element"].values())


def test_profile_artifact_kernel_section(tmp_path):
    art = tprofile.ProfileArtifact({"topology": "t"}, {},
                                   kernels={"decode_attention": 24})
    d = art.to_dict()
    assert d["kernels"] == {"decode_attention": 24}
    back = tprofile.ProfileArtifact.from_dict(json.loads(json.dumps(d)))
    back.merge(tprofile.ProfileArtifact({"topology": "t"}, {}, kernels={
        "decode_attention": 1, "flash_attention": 2}))
    assert back.summary()["kernels"] == {"decode_attention": 25,
                                         "flash_attention": 2}
    assert "kernels" not in tprofile.ProfileArtifact(
        {"topology": "t"}, {}).to_dict()
    # the reference reads a port artifact with the section
    p = tmp_path / "k.json"
    art.save(str(p))
    assert jprofile.ProfileArtifact.load(str(p)).key["topology"] == "t"


def test_kernel_launches_counted_from_start():
    from nnstreamer_tpu_torch.ops.decode_attention import decode_attention

    tprofile.start()
    try:
        decode_attention.launches += 3   # as three launches on a card
        pipe = parse_launch(port_line(FUSED, 2))
        pipe.run(timeout=30)
        art = tprofile.ProfileArtifact.capture(pipe)
    finally:
        decode_attention.launches -= 3
        tprofile.stop()
    assert art.kernels == {"decode_attention": 3}


@pytest.mark.parametrize("argv,rc", [
    (["obs", "metrics"], 0),
    (["obs", "flight", "--last", "4"], 0),
    (["obs", "slo"], 0),
    (["obs", "memory"], 0),
    (["obs", "quality"], 0),
    (["obs", "fleet"], 0),
    (["obs", "aot"], 0),
    (["obs", "top"], 0),
    (["obs", "top", "--interval", "0"], 2),
    (["obs", "flight", "--follow", "--interval", "0"], 2),
    (["obs", "trace", "--endpoint", "http://127.0.0.1:9"], 2),
    (["obs", "store"], 2),
])
def test_obs_verbs_in_this_process(monkeypatch, argv, rc):
    monkeypatch.delenv("NNS_PROFILE_STORE", raising=False)
    got_rc, out = _run(argv)
    assert got_rc == rc
    if rc == 0 and argv[1] not in ("metrics", "top"):
        json.loads(out)


def test_obs_trace_writes_spans(tmp_path):
    from nnstreamer_tpu_torch.obs import context as obs_context

    obs_context.enable_tracing()
    try:
        obs_context.record_span("cli-span", kind="span")
        out = str(tmp_path / "spans.json")
        rc, text = _run(["obs", "trace", "--out", out])
    finally:
        obs_context.disable_tracing()
    assert rc == 0 and "span(s) to" in text
    assert json.loads(open(out).read())["traceEvents"]


def test_obs_store_lists_and_prunes(tmp_path, monkeypatch):
    root = tmp_path / "store"
    assert _run(["obs", "store", "--root", str(root)])[0] == 2  # absent
    store = tprofile.ProfileStore(str(root))
    for i in range(3):
        store.save(tprofile.ProfileArtifact({"topology": f"t{i}"}, {}))
    rc, text = _run(["obs", "store", "--root", str(root)])
    assert rc == 0 and "3 artifact(s)" in text
    rc, text = _run(["obs", "store", "--root", str(root), "--prune", "1"])
    assert rc == 0 and "pruned 2 artifact(s)" in text
    assert len(store.list()) == 1


def test_follow_flight_tail_prints_only_new():
    feed = [[{"seq": 1, "name": "a"}, {"seq": 2, "name": "b"}], [],
            [{"seq": 3, "name": "c"}]]
    cursors = []

    def fetch(cursor):
        cursors.append(cursor)
        events = feed.pop(0) if feed else []
        if events:
            cursor = max(e["seq"] for e in events)
        return events, cursor
    out = io.StringIO()
    assert _follow_flight(fetch, interval=0.01, max_polls=3, out=out) == 0
    assert [json.loads(ln)["name"] for ln in out.getvalue().splitlines()] \
        == ["a", "b", "c"]
    assert cursors == [None, 2, 2]


@pytest.fixture
def endpoint():
    from nnstreamer_tpu_torch.service import ControlServer, ServiceManager

    mgr = ServiceManager()
    server = ControlServer(mgr).start()
    try:
        yield server.endpoint
    finally:
        mgr.shutdown()
        server.stop()


@pytest.mark.parametrize("verb", ["metrics", "flight", "slo", "memory",
                                  "quality", "fleet", "profile", "top",
                                  "aot"])
def test_obs_verbs_against_an_endpoint(endpoint, verb):
    from nnstreamer_tpu_torch.obs import flight as obs_flight

    obs_flight.record("clitest", "cli-ev", {})
    rc, out = _run(["obs", verb, "--endpoint", endpoint])
    assert rc == 0
    if verb == "flight":
        assert any(e["name"] == "cli-ev" for e in json.loads(out))
    elif verb == "metrics":
        assert "# TYPE" in out
    elif verb == "top":
        assert out.startswith("nns obs top")


# ---------------------------------------------------------------------------
# entry.py
# ---------------------------------------------------------------------------

def test_entry_exported_equals_eager_on_the_cpu():
    r = entry.entry(device="cpu")
    assert tuple(r.exported.shape) == (1, 1001)
    assert r.exported.device.type == "cpu"
    assert r.bit_equal
    assert np.isfinite(r.exported.numpy()).all()


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_multichip_on_a_gloo_world(n):
    out = entry.dryrun_multichip(n, device="cpu")
    assert out["world"] == n and out["backend"] == "gloo"
    assert out["mesh"]["dp"] * out["mesh"]["tp"] * out["mesh"]["sp"] == n
    assert abs(out["loss"] - out["meshless_loss"]) <= \
        entry.LOSS_RTOL * abs(out["meshless_loss"])


def test_entry_module_runs_alone():
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.modules['jax'] = None; "
         "sys.modules['nnstreamer_tpu'] = None; "
         "from nnstreamer_tpu_torch.entry import main; "
         "sys.exit(main(['multichip', '2', '--device', 'cpu']))"],
        cwd=str(root), capture_output=True, text=True, timeout=150,
        env=dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(proc.stdout.splitlines()[-1])["world"] == 2
