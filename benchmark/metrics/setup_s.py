"""Set-up: process start to the first push of the window (weights,
frames, the line, kernel builds, warm-up), on the host's clock."""


def read(rec):
    return rec.setup_s
