"""The port's graph lint (``nnstreamer_tpu_torch/analysis/graph_lint.py``)
against nnstreamer_tpu's on the launch lines, pipelines and pbtxt of the
reference's ``tests/test_lint.py``: the same rule codes, severities and
locations (element names, less the per-process counters of unnamed
elements), finding for finding."""
import re

import pytest

import nnstreamer_tpu.analysis as RA
import nnstreamer_tpu_torch.analysis as PA
from nnstreamer_tpu.registry.elements import make_element as r_make
from nnstreamer_tpu.runtime.parse import parse_launch as r_parse
from nnstreamer_tpu.runtime.pipeline import Pipeline as RPipeline
from nnstreamer_tpu_torch.registry.elements import make_element as p_make
from nnstreamer_tpu_torch.runtime.parse import parse_launch as p_parse
from nnstreamer_tpu_torch.runtime.pipeline import Pipeline as PPipeline

MODEL = "builtin://scaler?factor=2"

# every launch line that tests/test_lint.py hands to lint_launch
LINES = [
    "tensor_sr num-buffers=1 ! tensor_sink",
    "tensor_src num-buffers=1 ! tensor_sink",
    "tensor_src bogus=1 ! tensor_sink",
    "tensor_src dimensions=2 ! tensor_sink",
    f"tensor_src ! tensor_filter framework=jax model={MODEL} "
    "input=2 inputtype=float32 ! tensor_sink",
    "tensor_src dimensions=2 num-buffers=1 "
    "! other/tensors,dimensions=3 ! tensor_sink",
    "tensor_src dimensions=2 num-buffers=1 "
    "! other/tensors,dimensions=2 ! tensor_sink",
    "tensor_src dimensions=2 types=uint8 "
    "! other/tensors,types=float32 ! tensor_sink",
    "tensor_src num-buffers=1 ! tee name=t t. ! tensor_sink",
    "tensor_src num-buffers=1 ! tee name=t t. ! tensor_sink t. ! tensor_sink",
    "tensor_src num-buffers=1 ! tensor_mux name=m ! tensor_sink",
    "tensor_src num-buffers=1 ! tensor_mux name=m ! tensor_sink "
    "tensor_src num-buffers=1 ! m.",
    "appsrc caps=other/tensors,format=flexible "
    f"! tensor_filter framework=jax model={MODEL} ! tensor_sink",
    "appsrc caps=other/tensors,format=flexible "
    f"! tensor_filter framework=jax model={MODEL} "
    "invoke-dynamic=true ! tensor_sink",
    f"tensor_src dimensions=2 ! tensor_filter framework=jax model={MODEL} "
    "! tensor_sink",
    "tensor_src dimensions=3:8:8:16 num-buffers=1 "
    f"! tensor_serving model={MODEL} bucket-sizes=1,2,4,8 ! tensor_sink",
    "tensor_src dimensions=3:8:8:4 num-buffers=1 "
    f"! tensor_serving model={MODEL} bucket-sizes=1,2,4,8 ! tensor_sink",
    "tensor_src dimensions=4 num-buffers=1 "
    f"! tensor_filter framework=jax model={MODEL} "
    "! tensor_sparse_enc ! tensor_sparse_dec "
    "! tensor_transform mode=typecast option=float32 ! tensor_sink",
    "tensor_src dimensions=4 num-buffers=1 "
    f"! tensor_filter framework=jax model={MODEL} "
    "! tensor_sparse_enc ! tensor_sparse_dec ! tensor_sink",
    "tensor_src num-buffers=1 ! queue",
    "tensor_src ! tensor_decoder ! tensor_sink",
    "tensor_src num-buffers=1 ! queue ! tensor_sink",
    # the service plane's admission cases: a caps mismatch and an
    # unknown element in a managed line
    "tensor_src dimensions=3:224:224:4 types=uint8 num-buffers=1 "
    "! other/tensors,types=float32 ! tensor_sink",
    "tensor_src num-buffers=1 ! tensor_filtr model=x ! tensor_sink",
    "tensor_query_serversrc port=0 ! tensor_filter framework=torch "
    f"model={MODEL} ! tensor_query_serversink",
]


def _location(loc: str) -> str:
    """An element's location with its instance counter dropped
    (``capsfilter334`` → ``capsfilter``): each process numbers its
    unnamed elements from its own counter."""
    return re.sub(r"(?<=[a-z_])\d+(?=\.|$)", "", loc)


def _key(diags):
    return sorted((d.rule, str(d.severity), _location(d.location))
                  for d in diags)


@pytest.mark.parametrize("line", LINES, ids=range(len(LINES)))
def test_launch_line_gives_the_reference_diagnostics(line):
    want = RA.lint_launch(line)
    got = PA.lint_launch(line)
    assert _key(got) == _key(want)
    assert [d.rule for d in got] == [d.rule for d in want]


def test_unknown_element_hint_names_the_same_element():
    (r,) = [d for d in RA.lint_launch("tensor_sr num-buffers=1 ! "
                                      "tensor_sink") if d.rule == "NNL001"]
    (p,) = [d for d in PA.lint_launch("tensor_sr num-buffers=1 ! "
                                      "tensor_sink") if d.rule == "NNL001"]
    assert p.hint == r.hint and "tensor_src" in p.hint
    assert p.severity is PA.Severity.ERROR


def _isolated_source(parse, make, _pipe):
    pipe = parse("tensor_src num-buffers=1 ! tensor_sink")
    pipe.add(make("tensor_src"))
    return pipe


def _dangling(parse, make, _pipe):
    pipe = parse("tensor_src num-buffers=1 ! tensor_sink")
    q, s = make("queue"), make("tensor_sink")
    pipe.add(q, s)
    q.link(s)
    return pipe


def _cycle(_parse, make, pipe_cls):
    q1, q2 = make("queue"), make("queue")
    p = pipe_cls()
    p.add(q1, q2)
    q1.link(q2)
    q2.link(q1)
    return p


@pytest.mark.parametrize("build", [_isolated_source, _dangling, _cycle],
                         ids=["isolated_source", "dangling", "cycle"])
def test_constructed_pipeline_gives_the_reference_rules(build):
    want = RA.lint_pipeline(build(r_parse, r_make, RPipeline))
    got = PA.lint_pipeline(build(p_parse, p_make, PPipeline))
    assert _key(got) == _key(want)


def test_pbtxt_gives_the_reference_rules():
    from nnstreamer_tpu.runtime.pbtxt import to_pbtxt

    pb = to_pbtxt(r_parse(
        "tensor_src num-buffers=2 ! tensor_transform mode=typecast "
        "option=float32 ! tensor_sink"))
    assert PA.lint_pbtxt(pb) == [] == RA.lint_pbtxt(pb)
    assert _key(PA.lint_pbtxt("node { garbage")) == \
        _key(RA.lint_pbtxt("node { garbage"))


def test_rule_catalog_is_the_reference_catalog():
    assert {k: (r.severity.value, r.title) for k, r in PA.RULES.items()} \
        == {k: (r.severity.value, r.title) for k, r in RA.RULES.items()}
