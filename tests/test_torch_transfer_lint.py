"""The port's transfer lint (NNL4xx) against nnstreamer_tpu's.

Every snippet of the reference's ``tests/test_transfer.py`` (the string
handed to its ``_lint_snippet``) is read from that file. The JAX-spelled
ones each have a torch twin here (same lines, same dataflow: ``jnp.*``
results are ``torch.*`` ops on a ``.cuda()`` tensor, a ``jnp``
constructor is a ``torch`` constructor with ``device="cuda"``, a jit is a
CUDA-graph capture); the port's pass on the twin must give the
reference's ``(rule, line, severity)`` list on the original, less
NNL404: PyTorch has no buffer donation, so the port keeps the rule in
its catalog and never emits it. The other snippets go through both
passes as they are.
"""
import pytest

from nnstreamer_tpu.analysis import RULES as REF_RULES
from nnstreamer_tpu.analysis import transfer_lint as ref_pass
from nnstreamer_tpu_torch.analysis import RULES, Severity
from nnstreamer_tpu_torch.analysis import transfer_lint as port_pass
from test_torch_source_lint import jax_spelled, lint_list, reference_snippets

SNIPPETS = reference_snippets("test_transfer.py", with_subdir=True)

_NNL404_RUN = """
            import functools
            import torch

            def run(fn, batch):
                j = torch.cuda.make_graphed_callables(fn, (batch,))
                x = torch.as_tensor(batch, device="cuda")
                return j(x)
        """

TWINS = {
    "test_every_finding_carries_fix_hint": """
            import torch
            import numpy as np

            def chain(pad, buf):
                x = torch.as_tensor(buf, device="cuda")
                return np.asarray(x)
        """,
    "test_np_asarray_on_device_value_in_hot_fn": """
            import torch
            import numpy as np

            def transform(self, buf):
                y = torch.add(buf.cuda(), 1)
                return np.asarray(y)
        """,
    "test_scalar_pull_and_tolist": """
            import torch

            def chain(pad, buf):
                y = torch.sum(buf.cuda())
                a = float(y)
                b = y.tolist()
                return a, b
        """,
    "test_iteration_over_device_array_flags": """
            import torch

            def render(self, buf):
                y = torch.add(buf.cuda(), 1)
                for v in y:
                    print(v)
        """,
    "test_cold_function_not_flagged": """
            import torch
            import numpy as np

            def debug_dump(buf):
                y = torch.add(buf.cuda(), 1)
                return np.asarray(y)
        """,
    "test_call_expansion_credits_helper": """
            import torch
            import numpy as np

            def _compute(buf):
                return torch.add(buf.cuda(), 1)

            def chain(pad, buf):
                y = _compute(buf)
                return np.asarray(y)
        """,
    "test_fresh_constructor_in_hot_fn": """
            import torch

            def chain(pad, buf):
                pad_block = torch.zeros((8, 8), device="cuda")
                return torch.add(buf, pad_block)
        """,
    "test_jitted_closure_alloc_exempt": """
            import functools
            import torch

            def chain(pad, buf):
                def _k(x):
                    return x + torch.zeros((8, 8), device="cuda")
                return torch.cuda.make_graphed_callables(_k, (buf,))(buf)
        """,
    "test_init_time_alloc_not_flagged": """
            import torch

            def __init__(self):
                self._pad = torch.zeros((8, 8), device="cuda")
        """,
    "test_device_host_device_sandwich": """
            import torch
            import numpy as np

            def summarize(x):
                y = torch.add(x.cuda(), 1)
                h = np.asarray(y)
                return torch.as_tensor(h, device="cuda")
        """,
    "test_fresh_host_upload_is_not_a_sandwich": """
            import torch
            import numpy as np

            def prepare(shape):
                h = np.zeros(shape)
                return torch.as_tensor(h, device="cuda")
        """,
    "test_opportunity_single_owner_no_donate": _NNL404_RUN,
    "test_donated_and_unread_is_clean": _NNL404_RUN,
    "test_violation_donated_arg_read_after_call": """
            import functools
            import torch

            def run(fn, batch):
                j = torch.cuda.make_graphed_callables(fn, (batch,))
                x = torch.as_tensor(batch, device="cuda")
                y = j(x)
                return y, x.shape
        """,
    "test_carry_rebind_is_exempt": """
            import functools
            import torch

            def run(fn, batch, steps):
                j = torch.cuda.make_graphed_callables(fn, (batch,))
                x = torch.as_tensor(batch, device="cuda")
                for _ in range(steps):
                    x = j(x)
                return x
        """,
    "test_pragma_suppresses": """
            import torch

            def chain(pad, buf):
                # nnlint: disable=NNL402 — constant folded upstream
                pad_block = torch.zeros((8, 8), device="cuda")
                return torch.add(buf, pad_block)
        """,
    "test_skip_file_honored": """
            # nnlint: skip-file
            import torch
            import numpy as np

            def chain(pad, buf):
                return np.asarray(torch.add(buf.cuda(), 1))
        """,
}


def _twin(sid: str):
    return TWINS.get(sid.rsplit(":", 1)[0])


def test_every_snippet_is_read():
    assert len(SNIPPETS) == 22
    jaxy = {s.rsplit(":", 1)[0] for s, _, c in SNIPPETS if jax_spelled(c)}
    assert jaxy == set(TWINS)


def test_catalog_keeps_nnl404():
    for rid in ("NNL401", "NNL402", "NNL403", "NNL404", "NNL405"):
        assert RULES[rid].severity is Severity.WARNING
        assert RULES[rid].severity.value == REF_RULES[rid].severity.value


@pytest.mark.parametrize("sid,subdir,code", SNIPPETS,
                         ids=[s[0] for s in SNIPPETS])
def test_port_gives_the_references_findings(tmp_path, sid, subdir, code):
    want = [d for d in lint_list(ref_pass.lint_transfer, tmp_path, "ref",
                                 subdir, code) if d[0] != "NNL404"]
    twin = _twin(sid) if jax_spelled(code) else code
    got = lint_list(port_pass.lint_transfer, tmp_path, "port", subdir, twin)
    assert got == want


@pytest.mark.parametrize("sid,subdir,code", [
    s for s in SNIPPETS if s[0].startswith((
        "test_opportunity", "test_violation"))], ids=lambda v: str(v)[:40])
def test_nnl404_never_fires(tmp_path, sid, subdir, code):
    # the reference flags these two; the port flags neither the original
    # nor its twin
    assert "NNL404" in {d[0] for d in lint_list(
        ref_pass.lint_transfer, tmp_path, "ref", subdir, code)}
    for side, text in (("orig", code), ("twin", _twin(sid))):
        assert lint_list(port_pass.lint_transfer, tmp_path, side, subdir,
                         text) == []


def test_torch_seeds(tmp_path):
    got = lint_list(port_pass.lint_transfer, tmp_path, "port", "elements", """
        import torch

        class El:
            def chain(self, pad, buf):
                x = buf.to(self.device)
                host = x.cpu()                   # the explicit pull: fine
                n = x.sum().item()
                a = x.numpy()
                w = torch.ones(4, device=self.device)
                c = torch.zeros(4, device="cpu")  # a host tensor: fine
                y = host.to("cuda")
                return n, a, w, c, y
    """)
    assert [(r, ln) for r, ln, _ in got] == [
        ("NNL401", 8), ("NNL401", 9), ("NNL402", 10), ("NNL403", 12)]
