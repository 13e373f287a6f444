import time


def timed(fn):
    t0 = time.perf_counter()                   # R008
    fn()
    return time.perf_counter() - t0            # R008
