import ctypes


def bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    # R004: n is a long long in C, and the stream argument is missing
    lib.fixture_scale.argtypes = [p, i, i, ctypes.c_double]
    lib.fixture_scale.restype = i
    return lib
