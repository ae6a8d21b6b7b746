"""Runtime analysis: the sanitizers (``sanitizer.py``).

The port of part of nnstreamer_tpu's ``analysis/`` package; its lint
passes are not in this package yet.
"""
