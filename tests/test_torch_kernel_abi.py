"""The C interface of the port's CUDA library against its ctypes bindings.

`ops/_build.py` loads the kernels' shared library with `ctypes` and sets
each entry point's `argtypes` from `_SIGNATURES`.  A wrong entry there does
not fail to build: ctypes passes an int where a pointer was declared and
cuts the pointer to 32 bits, or shifts every later argument, and only the
card shows it.  These tests parse the `extern "C"` functions of
`csrc/*.cu` and hold each `_SIGNATURES` entry against them: same names,
same parameter count, the same pointer / int / float kinds in order.  They
need no compiler and no card.
"""

import ctypes
import re

import pytest

from bindyouravatar_tpu_torch.ops import _build

_EXTERN_C = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)
_CTYPES_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_float: "float",
                ctypes.c_longlong: "int64", ctypes.c_double: "double"}


def _param_kind(param: str) -> str:
    """The kind of one C parameter declaration ("const float* w" -> pointer)."""
    decl = " ".join(param.split())
    if "*" in decl:
        return "pointer"
    words = decl.split()[:-1]                  # the type, without the name
    if words.count("long") == 2:
        return "int64"
    for kind in ("float", "double", "int"):
        if kind in words:
            return kind
    raise ValueError(f"unknown C parameter type: {param!r}")


def _source_functions(src: str) -> dict:
    """name -> [parameter kinds] for every `extern "C"` function of one
    source of the build."""
    text = (_build.CSRC_DIR / src).read_text()
    text = re.sub(r"//[^\n]*", "", text)       # comments may quote declarations
    return {name: [_param_kind(p) for p in params.split(",") if p.strip()]
            for name, params in _EXTERN_C.findall(text)}


def _extern_c_functions() -> dict:
    """name -> (source file, [parameter kinds]) over the build's sources."""
    found = {}
    for src in _build.CUDA_SOURCES:
        for name, kinds in _source_functions(src).items():
            assert name not in found, f"{name} is defined in {found[name][0]} and {src}"
            found[name] = (src, kinds)
    return found


@pytest.mark.parametrize("source", _build.CUDA_SOURCES)
def test_every_entry_point_of_the_source_is_bound(source):
    """Each source the build compiles exists and defines entry points, and
    each of them has a ctypes signature, so nothing is called without
    `argtypes` (the other way round, each signature's function is found by
    the test below)."""
    assert (_build.CSRC_DIR / source).is_file()
    functions = _source_functions(source)
    assert functions, f"{source} defines no extern \"C\" function"
    assert set(functions) <= set(_build._SIGNATURES), set(functions) - set(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signature_matches_the_c_declaration(name):
    functions = _extern_c_functions()
    assert name in functions, f"{name} is bound in _SIGNATURES but defined in no CUDA source"
    src, c_kinds = functions[name]
    bound = [_CTYPES_KIND[t] for t in _build._SIGNATURES[name]]
    assert bound == c_kinds, f"{name} ({src}): ctypes {bound} against C {c_kinds}"


def test_param_kinds():
    assert _param_kind("const void* q") == "pointer"
    assert _param_kind("float* __restrict__ lse") == "pointer"
    assert _param_kind("int Sq") == "int"
    assert _param_kind("float scale") == "float"
    assert _param_kind("long long rows") == "int64"
