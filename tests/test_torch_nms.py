"""The port's NMS (ops/nms.py) against nnstreamer_tpu's ops/nms.py on the
CPU: ``iou_matrix`` and ``nms_numpy`` (copies) equal the reference's, and
``nms_torch`` keeps what ``nms_numpy`` keeps on random boxes.

Ties: ``nms_numpy`` orders equal scores by numpy's argsort, which is not a
stable sort, so the order among tied boxes is numpy's choice. There
``nms_torch`` is held exactly against ``nms_jax`` (nnstreamer_tpu's
fixed-size NMS, the function it ports: a stable sort, ties in index
order), and against ``nms_numpy`` by the kept count, the kept scores in
order, and the kept boxes."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nnstreamer_tpu.ops import nms as jnms
from nnstreamer_tpu_torch.ops import nms as tnms


def _boxes(rng, n):
    c = rng.random((n, 2)).astype(np.float32)
    hw = rng.uniform(0.05, 0.4, (n, 2)).astype(np.float32)
    return np.concatenate([c - hw / 2, c + hw / 2], axis=1).astype(np.float32)


def _torch(boxes, scores, **kw):
    kept, valid = tnms.nms_torch(torch.from_numpy(boxes),
                                 torch.from_numpy(scores), **kw)
    assert kept.dtype is torch.int64 and valid.dtype is torch.bool
    k = kept.numpy()
    assert (k[valid.numpy()] >= 0).all() and (k[~valid.numpy()] == -1).all()
    return k[valid.numpy()]


def test_iou_matrix_equals_reference():
    b = _boxes(np.random.default_rng(0), 40)
    np.testing.assert_array_equal(tnms.iou_matrix(b), jnms.iou_matrix(b))


@pytest.mark.parametrize("seed", range(3))
def test_nms_numpy_equals_reference(seed):
    rng = np.random.default_rng(seed)
    b, s = _boxes(rng, 300), rng.random(300).astype(np.float32)
    np.testing.assert_array_equal(tnms.nms_numpy(b, s), jnms.nms_numpy(b, s))


# (n, iou_threshold, score_threshold, max_out)
RANDOM_CASES = [(50, 0.5, 0.25, 100), (300, 0.5, 0.25, 100),
                (300, 0.3, 0.5, 10), (200, 0.7, 0.0, 100), (120, 0.05, 0.1, 5)]


@pytest.mark.parametrize("case", RANDOM_CASES, ids=lambda c: "-".join(map(str, c)))
def test_nms_torch_equals_nms_numpy(case):
    n, iou, thr, max_out = case
    rng = np.random.default_rng(n)
    b, s = _boxes(rng, n), rng.random(n).astype(np.float32)
    kw = dict(iou_threshold=iou, score_threshold=thr, max_out=max_out)
    want = tnms.nms_numpy(b, s, **kw)
    got = _torch(b, s, **kw)
    np.testing.assert_array_equal(got, want)
    assert 0 < len(got) <= max_out


@pytest.mark.parametrize("seed", range(4))
def test_nms_torch_ties(seed):
    """Scores in eighths and near-duplicate boxes: many ties, some of them
    between overlapping boxes — nms_jax's index order decides."""
    rng = np.random.default_rng(100 + seed)
    b = _boxes(rng, 80)
    b[40:] = b[:40] + rng.integers(0, 2, (40, 1)).astype(np.float32) * 0.01
    s = (rng.integers(1, 8, 80) / 8).astype(np.float32)
    got = _torch(b, s, max_out=30)
    kept, valid = jnms.nms_jax(jnp.asarray(b), jnp.asarray(s), max_out=30)
    np.testing.assert_array_equal(got, np.asarray(kept)[np.asarray(valid)])


@pytest.mark.parametrize("seed", range(4))
def test_nms_torch_ties_vs_nms_numpy(seed):
    """Every tie is a box and its exact duplicate (distinct boxes have
    distinct scores): whichever of a tied pair a sort puts first, the kept
    count, the kept scores in order and the kept boxes are the same."""
    rng = np.random.default_rng(200 + seed)
    b = _boxes(rng, 60)
    b[30:] = b[:30]
    s = np.tile(rng.permutation(30).astype(np.float32) / 30, 2)
    got = _torch(b, s, max_out=40)
    want = tnms.nms_numpy(b, s, max_out=40)
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(s[got], s[want])
    assert sorted(map(tuple, b[got].tolist())) == \
        sorted(map(tuple, b[want].tolist()))


def test_nms_torch_edges():
    empty = np.zeros((0, 4), np.float32)
    assert len(_torch(empty, np.zeros(0, np.float32))) == 0
    b = _boxes(np.random.default_rng(7), 10)
    assert len(_torch(b, np.full(10, 0.1, np.float32))) == 0
    # one box and its duplicate: the first (lower index) is kept
    dup = np.concatenate([b[:1], b[:1]])
    np.testing.assert_array_equal(_torch(dup, np.ones(2, np.float32)), [0])
