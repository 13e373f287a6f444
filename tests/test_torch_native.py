"""The port's native-library layer (``lightgbm_tpu_torch/ops/native.py``),
on the CPU: tiny C sources built with ``cc`` into a temporary directory
through the same build that compiles the kernels with nvcc and the C API
shim with ``cc``.

- a library's path is keyed by the source's bytes and by the key words;
- an existing library is not built again: the compiler is not called;
- a failing compile raises with the compiler's output and leaves neither a
  temporary file nor a library;
- ``load`` builds and loads a library once, and a ``declare`` that raises
  leaves nothing loaded; the wrappers' ``declare`` refuses a source whose
  constants are not the wrapper's;
- ``check_tensor``'s refusals, and the launch check naming the kernel.
"""
import ctypes
import hashlib
import os

import pytest
import torch

from lightgbm_tpu_torch.ops import cuda_histogram, cuda_lambdarank, native

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)


def _source(tmp_path, text, name="answer.c"):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _cc(source):
    return lambda out: ["cc", "-shared", "-fPIC", "-O1", source, "-o", out]


def _build(source, stem, build_dir):
    return native.build(source, stem, ["-O1"], _cc(source), str(build_dir))


ANSWER = "int answer(void) { return 42; }\n"


def test_library_path_is_keyed_by_the_source_and_the_key_words(tmp_path):
    src = _source(tmp_path, ANSWER)
    path = native.library_path(src, "libx", ["-O1", "-g"], str(tmp_path))
    digest = hashlib.sha256(ANSWER.encode() + b"-O1 -g").hexdigest()[:16]
    assert path == os.path.join(str(tmp_path), f"libx_{digest}.so")
    assert native.library_path(src, "libx", ["-O1 -g"], str(tmp_path)) \
        == path                           # the words joined by one space
    assert native.library_path(src, "libx", ["-O2", "-g"],
                               str(tmp_path)) != path
    _source(tmp_path, ANSWER + "\n")
    assert native.library_path(src, "libx", ["-O1", "-g"],
                               str(tmp_path)) != path


def test_an_existing_library_is_not_built_again(tmp_path):
    src = _source(tmp_path, ANSWER)
    path, seconds, _ = _build(src, "libanswer", tmp_path / "build")
    assert os.path.exists(path) and seconds > 0

    def no_compiler(out):
        raise AssertionError("the compiler was called again")
    again = native.build(src, "libanswer", ["-O1"], no_compiler,
                         str(tmp_path / "build"))
    assert again == (path, 0.0, "")


@pytest.mark.parametrize("compiler", ["cc", "partial_output"])
def test_a_failing_compile_raises_and_leaves_no_file(tmp_path, compiler):
    """``cc`` on a syntax error; a compiler that writes part of its output
    and then fails."""
    src = _source(tmp_path, "int answer(void) { return 42 }\n")
    command = _cc(src) if compiler == "cc" else (
        lambda out: ["sh", "-c", f"echo partial > '{out}'; "
                                 f"echo 'broken input' >&2; exit 3"])
    build_dir = tmp_path / "build"
    with pytest.raises(RuntimeError) as err:
        native.build(src, "libanswer", ["-O1"], command, str(build_dir))
    if compiler == "cc":
        assert "cc failed (1)" in str(err.value)
        assert "error" in str(err.value)
    else:
        assert "sh failed (3)" in str(err.value)
        assert "broken input" in str(err.value)
    assert os.listdir(build_dir) == []


def test_load_builds_and_loads_once(tmp_path):
    src = _source(tmp_path, ANSWER)
    built, declared = [], []

    def build_fn(source, stem):
        built.append(stem)
        return _build(source, stem, tmp_path / "build")

    def declare(lib):
        declared.append(lib)
        lib.answer.argtypes = []
        lib.answer.restype = ctypes.c_int

    lib = native.load(src, "libanswer", declare, build_fn)
    assert native.load(src, "libanswer", declare, build_fn) is lib
    assert built == ["libanswer"] and declared == [lib]
    assert lib.answer() == 42


def test_a_declare_that_raises_leaves_nothing_loaded(tmp_path):
    src = _source(tmp_path, "int tile(void) { return 64; }\n", "tile.c")
    tiles = []

    def declare(want):
        def bind(lib):
            lib.tile.argtypes = []
            lib.tile.restype = ctypes.c_int
            tiles.append(lib.tile())
            if lib.tile() != want:
                raise RuntimeError("tile.c's tile differs from TILE")
        return bind

    def build_fn(source, stem):
        return _build(source, stem, tmp_path / "build")
    with pytest.raises(RuntimeError, match="differs from TILE"):
        native.load(src, "libtile", declare(128), build_fn)
    lib = native.load(src, "libtile", declare(64), build_fn)
    assert tiles == [64, 64] and lib.tile() == 64


class _FakeLib:
    """A library whose every function returns its entry of ``values`` (0
    where none) and takes any binding."""

    def __init__(self, **values):
        self._values = values

    def __getattr__(self, name):
        value = self._values.get(name, 0)

        def fn(*_):
            return value
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("wrapper,good,bad", [
    (cuda_histogram, dict(gbdt_hist_threads=1024),
     dict(gbdt_hist_threads=512)),
    (cuda_lambdarank, dict(gbdt_lambdarank_tile=128,
                           gbdt_lambdarank_chunk=512),
     dict(gbdt_lambdarank_tile=128, gbdt_lambdarank_chunk=256))],
    ids=["histogram", "lambdarank"])
def test_a_wrappers_declare_refuses_other_constants(wrapper, good, bad):
    lib = _FakeLib(**good)
    wrapper.declare(lib)
    with pytest.raises(RuntimeError, match="differs from"):
        wrapper.declare(_FakeLib(**bad))


@pytest.mark.parametrize("tensor,dtypes,shape,error,match", [
    ([1.0, 2.0], (torch.float32,), None, TypeError, "must be a tensor"),
    (torch.zeros(4, dtype=torch.float64), (torch.float32, torch.int32),
     None, TypeError, "torch.float32 or torch.int32, got torch.float64"),
    (torch.zeros(4), (torch.float32,), (5,), ValueError,
     r"shape \(5,\), got \(4,\)"),
    (torch.zeros(4, 2).t(), (torch.float32,), None, ValueError,
     "contiguous"),
    (torch.zeros(4), (torch.float32,), (4,), ValueError,
     "must be a CUDA tensor, got cpu")],
    ids=["not_a_tensor", "dtype", "shape", "strided", "on_the_cpu"])
def test_check_tensor_refuses(tensor, dtypes, shape, error, match):
    with pytest.raises(error, match=match):
        native.check_tensor("x", tensor, dtypes, shape)


def test_the_launch_check_names_the_kernel():
    native.check_launch("encode kernel", 0)
    with pytest.raises(RuntimeError,
                       match="^encode kernel launch failed: CUDA error 700$"):
        native.check_launch("encode kernel", 700)
