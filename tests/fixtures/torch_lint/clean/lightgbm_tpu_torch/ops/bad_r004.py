import ctypes


def bind(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fixture_scale.argtypes = [p, ll, i, ctypes.c_double, p]
    lib.fixture_scale.restype = i
    lib.fixture_bytes.argtypes = [i]
    lib.fixture_bytes.restype = ll
    return lib
