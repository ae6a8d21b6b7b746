"""Shared utilities (logging, invoke statistics, thread tracking, devices)."""
