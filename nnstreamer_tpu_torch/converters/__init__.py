"""Converter subplugins: external media/bytes → tensor streams.

Reference analog: ``ext/nnstreamer/tensor_converter/`` (flatbuf/flexbuf/
protobuf/python, SURVEY.md §2.6). The tensor_converter element delegates
IDL byte streams and its ``subplugin`` property to these. The port has
``flexbuf``, ``protobuf`` and ``flatbuf``; the python converter is not in
this package yet.
"""
from .base import Converter, register_converter  # noqa: F401
from . import bytes_converter  # noqa: F401
