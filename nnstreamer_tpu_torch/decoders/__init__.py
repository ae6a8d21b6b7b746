"""Decoder subplugins: tensor streams → media streams.

Reference analog: ``ext/nnstreamer/tensor_decoder/`` (SURVEY.md §2.5).
Importing this package registers every built-in decoder. The port has
``image_labeling``, ``direct_video``, ``octet_stream``, ``flexbuf``,
``protobuf`` and ``flatbuf`` so far; nnstreamer_tpu's other modes are not
in this package yet.
"""
from .base import Decoder, register_decoder  # noqa: F401
from . import simple  # noqa: F401
from . import serialize  # noqa: F401
