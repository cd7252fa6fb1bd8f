"""The SASS scan of ``kernel_ab.py --sass`` on hand-written listings: it must find a write
to the A fragments or the accumulators of a wgmma still in flight, and a read of its
accumulators, across a loop's back edge too, and pass a pipeline that waits before it
touches them. Runs on the CPU: no nvcc or card is needed."""

import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _kernel_ab():
    spec = importlib.util.spec_from_file_location("kernel_ab", ROOT / "kernel_ab.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


HEAD = """
\tcode for sm_90a
\t\tFunction : _Z4scanv
\t.headerflags\t@"EF_CUDA_SM90"
"""


def _listing(lines):
    """A cuobjdump -sass listing of one function from instruction texts and labels."""
    out, addr = [HEAD], 0
    for line in lines:
        if line.endswith(":"):
            out.append(line)
            continue
        out.append(f"        /*{addr:04x}*/                   {line} ;")
        addr += 16
    return "\n".join(out)


# two register sets in turn, each rebuilt after wait_group 1 retired the group that read it
CLEAN = [
    "LDS R88, [R3]",
    "WARPGROUP.ARRIVE",
    "HGMMA.64x64x16.F32.BF16 R24, R88, gdesc[UR4], RZ, !UPT, gsb0",
    ".L_x_1:",
    "LDS R92, [R3+0x10]",
    "WARPGROUP.ARRIVE",
    "HGMMA.64x64x16.F32.BF16 R24, R92, gdesc[UR4], R24, gsb0",
    "WARPGROUP.DEPBAR.LE gsb0, 0x1",
    "LDS R88, [R3+0x20]",
    "WARPGROUP.ARRIVE",
    "HGMMA.64x64x16.F32.BF16 R24, R88, gdesc[UR8], R24, gsb0",
    "WARPGROUP.DEPBAR.LE gsb0, 0x1",
    "@P0 BRA `(.L_x_1)",
    "WARPGROUP.DEPBAR.LE gsb0, 0x0",
    "STS.128 [R5], R24",
    "EXIT",
]


@pytest.mark.parametrize("case,kind,addr", [
    # the loop's first set (R92) is rebuilt at its top while the previous iteration's group
    # that read it may still run (no wait before the back edge): not on the path from the
    # entry, so the must scan does not see it
    ("loop", "may write", 0x30),
    # a set moved aside inside one group's flight: its registers overwritten on every path
    ("move", "must write", 0x50),
    # the accumulators stored before the last wait
    ("acc", "must read accumulator", 0xc0),
    ("clean", None, None),
])
def test_sass_scan_finds_in_flight_accesses(case, kind, addr):
    ab = _kernel_ab()
    lines = list(CLEAN)
    if case == "loop":
        del lines[11]  # the wait after the loop's second group
    elif case == "move":
        lines.insert(6, "MOV R90, R7")  # R88..R91 are the first group's A
    elif case == "acc":
        lines[13], lines[14] = lines[14], lines[13]
    funcs, labels = ab.parse_sass(_listing(lines))
    scan = ab.gmma_hazards(funcs["_Z4scanv"], labels["_Z4scanv"])
    assert (scan["gmma"], scan["gmma_a_from_registers"], scan["unresolved_branches"]) == (3, 3, 0)
    if kind is None:
        assert (scan["hazards_may"], scan["hazards_must"]) == (0, 0), scan["first_hazards"]
    else:
        assert scan["hazards_may"] >= 1
        assert scan["hazards_must"] == (0 if kind.startswith("may") else 1)
        assert scan["first_hazards"][0].startswith(f"/*{addr:04x}*/ {kind}:"), scan
