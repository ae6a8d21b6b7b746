"""Host↔device transport of the port (``staging``: pinned double-buffered
host→device staging for placed fused segments)."""
