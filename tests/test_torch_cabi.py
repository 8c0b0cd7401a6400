"""The C interfaces of the port's kernels against their ctypes bindings.

Every ``extern "C"`` function in ``tpu9_torch/csrc/*.cu`` is parsed from
its source and its arguments are held, one for one, against the
``argtypes`` its wrapper sets (module constants beside each ``_..._fn``):
a pointer against ``c_void_p``, an ``int`` against ``c_int``, a ``float``
against ``c_float``. ctypes passes an argument by the type it is told, so
a pointer bound as ``c_int`` would be cut to 32 bits and a missing
argument would shift every later one; either shows only on the card, as a
wrong address. This needs no compiler and no card.
"""

import ctypes
import re
from pathlib import Path

import pytest

from tpu9_torch.ops import attention as tattn
from tpu9_torch.ops import paged_attention as tpaged

CSRC = Path(tattn.__file__).resolve().parent.parent / "csrc"
KINDS = {"pointer": ctypes.c_void_p, "int": ctypes.c_int,
         "float": ctypes.c_float}


def c_entries(text: str) -> dict[str, list[str]]:
    """``{name: [kind of each argument]}`` of every ``extern "C"``
    function defined in a C++ source, each kind "pointer", "int" or
    "float"."""
    found = {}
    for m in re.finditer(r'extern\s+"C"\s+\w+\s+(\w+)\s*\(([^)]*)\)\s*\{',
                         text):
        kinds = []
        for arg in m.group(2).split(","):
            arg = " ".join(arg.split())
            if "*" in arg:
                kinds.append("pointer")
            elif re.match(r"(const )?int \w+$", arg):
                kinds.append("int")
            elif re.match(r"(const )?float \w+$", arg):
                kinds.append("float")
            else:
                raise ValueError(f"{m.group(1)}: argument {arg!r} has no "
                                 f"ctypes kind")
        found[m.group(1)] = kinds
    return found


def source_entries() -> dict[str, list[str]]:
    out = {}
    for path in sorted(CSRC.glob("*.cu")):
        for name, kinds in c_entries(path.read_text()).items():
            assert name not in out, f"{name} defined twice"
            out[name] = kinds
    return out


# each C entry, as its wrapper names it, and the argtypes it binds it with
BINDINGS = {
    tattn.FLASH_ENTRY: lambda: tattn.FLASH_ARGTYPES,
    tattn.FLASH_BACKWARD_ENTRY: lambda: tattn.FLASH_BACKWARD_ARGTYPES,
    **{symbol: (lambda i=instance: tpaged.PAGED_ARGTYPES[i])
       for instance, (symbol, _) in tpaged._ENTRIES.items()},
}


def test_every_c_entry_is_bound():
    """Each ``extern "C"`` function of the sources has a binding here, and
    each binding names a function of the sources."""
    assert set(source_entries()) == set(BINDINGS)


@pytest.mark.parametrize("symbol", sorted(BINDINGS))
def test_argtypes_match_the_c_interface(symbol):
    kinds = source_entries()[symbol]
    bound = BINDINGS[symbol]()
    assert len(bound) == len(kinds), (symbol, len(bound), len(kinds))
    for i, (kind, ctype) in enumerate(zip(kinds, bound)):
        assert KINDS[kind] is ctype, (symbol, i, kind, ctype)


def test_parser_reads_each_kind_and_refuses_the_unknown():
    text = ('extern "C" int f(const void* a, float* b, int n,\n'
            '                 float scale, void* stream) {\n  return 0;\n}\n'
            'int g(int x) { return x; }\n')
    assert c_entries(text) == {
        "f": ["pointer", "pointer", "int", "float", "pointer"]}
    with pytest.raises(ValueError, match="no ctypes kind"):
        c_entries('extern "C" int h(long long n) {\n}\n')


def test_a_cut_pointer_or_a_shifted_argument_is_caught():
    """The check fails for the faults it guards against: a pointer bound as
    ``c_int``, and an argument left out."""
    kinds = source_entries()[tattn.FLASH_BACKWARD_ENTRY]
    cut = list(tattn.FLASH_BACKWARD_ARGTYPES)
    cut[7] = ctypes.c_int
    assert any(KINDS[k] is not c for k, c in zip(kinds, cut))
    short = list(tattn.FLASH_BACKWARD_ARGTYPES)
    del short[7]
    assert len(short) != len(kinds)
