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
        set(mutants.MUTANTS) - set(mutants.CPU_CHECKED)) | set(mutants.VL_CHECKED)
