"""The kernel library's ctypes declarations (``_build._SIGNATURES`` and
``_RESTYPES``) match the entry points' ``extern "C"`` definitions in
``csrc/``: a parameter declared with another kind or in another place would
pass the card a wrong argument without any error, so each entry point's
parameters are parsed from its source and held to its declaration."""

import ctypes
import re

import pytest

from gym_anm_torch import _build

_SCALARS = {"int": ctypes.c_int, "float": ctypes.c_float, "double": ctypes.c_double, "long long": ctypes.c_longlong}


def _macros(src):
    """The function-like ``#define``s of ``src``: name -> (parameter, body)."""
    out = {}
    for name, param, body in re.findall(r"#define (\w+)\((\w+)\)((?:[^\n]*\\\n)*[^\n]*)", src):
        out[name] = (param, " ".join(line.rstrip("\\").strip() for line in body.split("\n")))
    return out


def _entry(src, name):
    """(return type, parameters) of the ``extern "C"`` definition of ``name``
    in ``src``, its macros' uses (as ``K3_ARGS(float)``) expanded."""
    found = re.findall(r'extern "C" (int|long long) ' + name + r"\((.*?)\)\s*\{", src, re.S)
    assert len(found) == 1, f"{name}: {len(found)} definitions"
    restype, sig = found[0]
    for macro, (param, body) in _macros(src).items():
        sig = re.sub(macro + r"\((\w+)\)", lambda m: re.sub(r"\b" + param + r"\b", m.group(1), body), sig)
    return restype, [p.strip() for p in sig.split(",") if p.strip()]


def _ctype(param):
    """The ctypes type a C parameter takes: a pointer, or a scalar by its type."""
    return ctypes.c_void_p if "*" in param else _SCALARS[param.rsplit(None, 1)[0]]


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_kernel_entry_points_match_their_ctypes_signatures(name):
    src = "\n".join(f.read_text() for f in sorted(_build.CSRC_DIR.glob("*.cu")))
    restype, params = _entry(src, name)
    assert [_ctype(p) for p in params] == list(_build._SIGNATURES[name])
    assert _SCALARS[restype] is _build._RESTYPES.get(name, ctypes.c_int)
