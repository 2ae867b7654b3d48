"""The mutation check's planted faults (`dynamo_tpu_torch/mutants.py`) still
apply: each mutant's text occurs exactly once in its kernel source, so a
kernel edit that moves the text fails here, on the CPU, and not only when
`python3 -m dynamo_tpu_torch.mutants` runs on the card.
"""

from __future__ import annotations

import os

import pytest

from dynamo_tpu_torch import mutants


@pytest.mark.parametrize("name", sorted(mutants.MUTANTS))
def test_mutant_text_occurs_once(name):
    source, old, new = mutants.MUTANTS[name]
    with open(os.path.join(mutants.ROOT, mutants.CSRC, source)) as f:
        src = f.read()
    assert src.count(old) == 1
    assert old != new


def test_cpu_checked_mutants_name_their_test_files():
    """Each mutant the CPU tests must see is a mutant of the table, its
    test file exists, and the card runner takes every other mutant and
    those its probes see."""
    for name, test in mutants.CPU_CHECKED.items():
        assert name in mutants.MUTANTS
        assert os.path.exists(os.path.join(mutants.ROOT, test))
    assert set(mutants.CARD_CHECKED) == (
        set(mutants.MUTANTS) - set(mutants.CPU_CHECKED)) | set(
            mutants.VL_CHECKED) | set(mutants.PP_CHECKED) | set(
                mutants.SP_CHECKED)


@pytest.mark.parametrize("stdout, rc, caught", [
    ('{"dp_probe": {"problems": ["A_64 flips"]}}\n', 0, True),
    ('{"dp_probe": {"problems": []}}\n', 0, False),
    ("", 1, False),  # the probe crashed before its comparison
    ('{"dp_probe": {"problems": ["A_64 flips"]}}\n', 1, False),
], ids=["problems", "clean", "crashed", "line_then_crash"])
def test_probe_verdict_needs_the_probes_line(stdout, rc, caught):
    """A card probe catches a mutant only by the problems its JSON line
    names: a probe that crashes (no line, or a failing exit) misses it."""
    assert mutants.probe_verdict(stdout, "dp_probe", rc)[0] is caught


def test_chip_smoke_probes_are_defined():
    """Every `*_main` that chip_smoke.py's `main` dispatches to (the
    mutation check's probes among them) is defined in the script, and
    each probe flag the card runner passes is one `main` reads."""
    import ast

    path = os.path.join(mutants.ROOT, "chip_smoke.py")
    tree = ast.parse(open(path).read(), path)
    defs = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    called = {c.func.id for c in ast.walk(main) if isinstance(c, ast.Call)
              and isinstance(c.func, ast.Name) and c.func.id.endswith("_main")}
    assert called and called <= defs, called - defs
    flags = {c.value for c in ast.walk(main) if isinstance(c, ast.Constant)
             and isinstance(c.value, str) and c.value.endswith("-probe")}
    for code in (mutants._DP_PROBE, mutants._VL_PROBE, mutants._PP_PROBE,
                 mutants._SP_PROBE):
        flag = code.split("sys.argv[1:] = ['")[1].split("'")[0]
        assert flag in flags, flag
