"""The C interface of the port's kernels against its ctypes binding, read
from the sources' text, so that it holds where no kernel can be built: each
``extern "C"`` function of ``cmhse_tpu_torch/csrc/*.cu`` takes the number
and kinds of parameters (pointer, int, float) that ``cuda_lib._SIGNATURES``
declares and returns what ``cuda_lib.library()`` binds it to; every name
bound is defined; every source is built. A mismatch would pass ctypes'
arguments in the wrong slots on the card."""

import ctypes
import re
import types

import pytest

from cmhse_tpu_torch.ops import cuda_lib

EXTERN = re.compile(r'extern\s+"C"\s+(?P<ret>[\w\s*]+?)\s*\b(?P<name>\w+)\s*'
                    r'\((?P<params>[^)]*)\)\s*\{')
KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
         ctypes.c_float: "float"}
# bound by library() on its own, not through _SIGNATURES
ERROR_STRING = "cmhse_error_string"


def _param_kind(param: str) -> str:
    if "*" in param:
        return "pointer"
    words = param.replace("const", " ").split()
    if len(words) != 2 or words[0] not in ("int", "float"):
        raise ValueError(f"a parameter ctypes has no kind for: {param!r}")
    return words[0]


def _extern_functions() -> dict:
    """name -> (return type, [parameter kinds], source) of every
    ``extern "C"`` function in the sources."""
    found = {}
    for path in sorted(cuda_lib.CSRC.glob("*.cu")):
        for m in EXTERN.finditer(path.read_text()):
            params = [p.strip() for p in m["params"].split(",") if p.strip()]
            ret = " ".join(m["ret"].split()).replace(" *", "*")
            assert m["name"] not in found, m["name"]
            found[m["name"]] = (ret, [_param_kind(p) for p in params],
                                path.name)
    return found


FUNCTIONS = _extern_functions()


@pytest.mark.parametrize("name", sorted(set(FUNCTIONS) - {ERROR_STRING}))
def test_extern_function_matches_its_binding(name):
    ret, kinds, source = FUNCTIONS[name]
    assert name in cuda_lib._SIGNATURES, (name, source)
    assert [KINDS[a] for a in cuda_lib._SIGNATURES[name]] == kinds, source
    assert ret == "int"


@pytest.mark.parametrize("name", sorted(cuda_lib._SIGNATURES))
def test_every_binding_is_defined_in_a_source(name):
    assert name in FUNCTIONS


def test_every_launcher_returns_int():
    assert {n: ret for n, (ret, _, _) in FUNCTIONS.items()
            if n != ERROR_STRING} == {n: "int" for n in cuda_lib._SIGNATURES}


def _params(name: str) -> list[str]:
    """The parameter names of ``extern "C"`` function ``name``, in
    order."""
    source = cuda_lib.CSRC / FUNCTIONS[name][2]
    m = next(m for m in EXTERN.finditer(source.read_text())
             if m["name"] == name)
    return [p.split()[-1].lstrip("*") for p in m["params"].split(",")]


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_gru_launchers_of_a_direction_take_one_argument_list(direction):
    """The resident and streamed launchers of a GRU direction take the
    same parameters, by name and kind, the live rows' plan (order, counts)
    among them, and share one binding."""
    resident, streamed = (f"cmhse_gru_{direction}",
                          f"cmhse_gru_{direction}_streamed")
    assert _params(resident) == _params(streamed)
    assert {"order", "counts"} <= set(_params(resident))
    assert FUNCTIONS[resident][1] == FUNCTIONS[streamed][1]
    assert cuda_lib._SIGNATURES[resident] is cuda_lib._SIGNATURES[streamed]


def test_library_binds_each_function_as_declared(monkeypatch):
    """library() on a stand-in for the built library: every function gets
    its declared argtypes and restype, cmhse_error_string its own."""
    fake = types.SimpleNamespace(**{n: types.SimpleNamespace()
                                    for n in FUNCTIONS})
    monkeypatch.setattr(cuda_lib, "build", lambda: "libcmhse_kernels.so")
    monkeypatch.setattr(cuda_lib.ctypes, "CDLL", lambda path: fake)
    cuda_lib.library.cache_clear()
    try:
        assert cuda_lib.library() is fake
    finally:
        cuda_lib.library.cache_clear()
    for name, argtypes in cuda_lib._SIGNATURES.items():
        fn = getattr(fake, name)
        assert fn.argtypes == list(argtypes), name
        assert fn.restype == ctypes.c_int, name
    ret, kinds, _ = FUNCTIONS[ERROR_STRING]
    assert (ret, kinds) == ("const char*", ["int"])
    assert fake.cmhse_error_string.argtypes == [ctypes.c_int]
    assert fake.cmhse_error_string.restype == ctypes.c_char_p


def test_sources_exist_and_every_kernel_source_is_built():
    on_disk = {p.name for p in cuda_lib.CSRC.glob("*.cu")}
    assert set(cuda_lib.SOURCES) == on_disk
    assert len(cuda_lib.SOURCES) == len(on_disk)
    assert {p.name for p in cuda_lib.CSRC.glob("*.cuh")} == set(
        cuda_lib.HEADERS)
