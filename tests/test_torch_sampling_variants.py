"""The mutants and design variants of ``tools/sampling_variants`` against
the sampling kernel's source, on the CPU: each is string replacements of
``ops/csrc/sampling.cu``, so every string it replaces must still be there,
once, and each edit must change the source. The tool itself builds and runs
the copies on a card."""
import pytest

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.tools import sampling_variants as sv

SRC = (_build.CSRC / "sampling.cu").read_text()
EDITS = {**{n: e for n, (e, _) in sv.VARIANTS.items()}, **sv.MUTANTS}


@pytest.mark.parametrize("name", sorted(n for n, e in EDITS.items()
                                        if e is not None))
def test_sampling_edit_still_applies_to_the_kernel_source(name):
    text = SRC
    for old, new in _build.edit_pairs(EDITS[name]):
        assert old in text, name
        assert old != new
        text = text.replace(old, new)
    assert text != SRC


@pytest.mark.parametrize("old", [sv.CUT, sv.KTH, sv.TOPP, sv.OFFSET, sv.TIE,
                                 sv.THREADS, sv.GATHER, sv.WARP_SORT,
                                 sv.WARP_DEN, sv.VECTOR,
                                 sv.RANGE, sv.SOFTMAX, sv.TOPP_START, sv.CUM,
                                 sv.BARRIER])
def test_sampling_edit_targets_are_unique(old):
    assert SRC.count(old) == 1, old

