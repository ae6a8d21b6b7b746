"""Core tensor data model and stream substrate types (L1)."""
from .tensors import (  # noqa: F401
    MAX_RANK,
    MAX_TENSORS,
    DataType,
    TensorFormat,
    TensorSpec,
    TensorsInfo,
    validate_arrays,
)
from .caps import (  # noqa: F401
    ANY,
    AUDIO_MIME,
    Caps,
    IntRange,
    OCTET_MIME,
    Structure,
    TENSORS_MIME,
    TEXT_MIME,
    VIDEO_MIME,
    ValueList,
    caps_from_tensors_info,
    parse_caps_string,
    tensors_any_caps,
    tensors_info_from_caps,
)
from .buffer import Buffer, clock_now  # noqa: F401
from .events import Event, EventType, Message, MessageType  # noqa: F401
from .data import TypedValue, parse_number  # noqa: F401
