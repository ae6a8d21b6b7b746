"""Registers the queue element with the factory registry (kept separate from
queue.py to avoid an import cycle between runtime and registry)."""
from ..registry.elements import register_element
from .queue import QueueElement

register_element(QueueElement)
