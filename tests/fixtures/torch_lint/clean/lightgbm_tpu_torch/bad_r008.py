import time


def deadline(seconds):
    return time.monotonic() + seconds
