"""The mutants and design variants of ``tools/decode_variants`` against the
paged kernel source, on the CPU: each is string replacements of
``ops/csrc/paged_attention.cu``, so every string it replaces must still be
there, once, and each edit must change the source. The tool itself builds
and runs the copies on a card."""
import pytest

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.tools import decode_variants as dv

SRC = (_build.CSRC / "paged_attention.cu").read_text()
EDITS = {**{n: e for n, (e, _) in dv.VARIANTS.items()}, **dv.MUTANTS}


@pytest.mark.parametrize("name", sorted(n for n, e in EDITS.items()
                                        if e is not None))
def test_decode_edit_still_applies_to_the_kernel_source(name):
    text = SRC
    for old, new in _build.edit_pairs(EDITS[name]):
        assert old in text, name
        assert old != new
        text = text.replace(old, new)
    assert text != SRC


@pytest.mark.parametrize("old", [dv.KEYS, dv.MERGED, dv.STEP2, dv.RESET,
                                 dv.SHARE, dv.GROUP, dv.WARPS, dv.EXP,
                                 dv.ONE_SPLIT, dv.MERGE_TAIL, dv.LAUNCHED,
                                 dv.PIPE, dv.TICKET, dv.TABLE])
def test_decode_edit_targets_are_unique(old):
    """A mutant or variant must touch the decode kernel only, once."""
    assert SRC.count(old) == 1, old


def test_the_mutants_cover_the_decode_contract():
    assert set(dv.MUTANTS) == {"last_key_dropped", "split_left_out",
                               "second_step_skipped", "ticket_not_reset"}
    assert dv.VARIANTS["this_tree"] == (None, None)


@pytest.mark.parametrize("name,splits", [("fixed_keys_128", 16),
                                         ("fixed_keys_256", 8),
                                         ("splits_8", 8)])
def test_variant_grids_fit_the_merge(name, splits):
    """A variant's fixed grid covers the timing table's keys and stays
    within what one merge takes."""
    assert dv.VARIANTS[name][1] == splits <= dv.pa.MAX_SPLITS
