"""Decoder subplugins: tensor streams → media streams.

Reference analog: ``ext/nnstreamer/tensor_decoder/`` (SURVEY.md §2.5).
Importing this package registers every built-in decoder. The port has
``image_labeling``, ``direct_video``, ``octet_stream``, ``tensor_region``,
``font``, ``bounding_boxes``, ``image_segment``, ``pose_estimation``,
``flexbuf``, ``protobuf`` and ``flatbuf``; nnstreamer_tpu's ``python3``
mode is not in this package yet.
"""
from .base import Decoder, register_decoder  # noqa: F401
from . import simple  # noqa: F401
from . import font  # noqa: F401
from . import bounding_boxes  # noqa: F401
from . import segment_pose  # noqa: F401
from . import serialize  # noqa: F401
