"""The mutants and design variants of ``tools/flash_bwd_variants`` against
the flash kernel source, on the CPU: each is one string replacement of
``ops/csrc/flash_attention.cu``, so every string it replaces must still be
there, once where it must be unique, and each edit must change the source.
The tool itself builds and runs the copies on a card."""
import pytest

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.tools import flash_bwd_variants as fv

SRC = (_build.CSRC / "flash_attention.cu").read_text()
EDITS = {**fv.VARIANTS, **fv.MUTANTS}


@pytest.mark.parametrize("name", sorted(n for n, e in EDITS.items()
                                        if e is not None))
def test_flash_bwd_edit_still_applies_to_the_kernel_source(name):
    old, new = EDITS[name]
    assert old in SRC, name
    assert old != new and SRC.replace(old, new) != SRC


@pytest.mark.parametrize("old", [fv.DKV_SKIP, fv.DQ_SKIP, fv.DKV_MASK,
                                 fv.DQ_MASK, fv.DKV_TILES, fv.DQ_TILES,
                                 fv.EXP])
def test_flash_bwd_edit_targets_are_unique(old):
    """A mutant or a tile variant must touch one kernel only."""
    assert SRC.count(old) == 1, old


def test_every_tensor_core_backward_kernel_has_two_mutants():
    kernels = {name.split("_")[0] for name in fv.MUTANTS}
    assert kernels == {"dkv", "dq"}
    for k in kernels:
        assert {f"{k}_tile_dropped", f"{k}_diagonal_off_by_one"} \
            <= set(fv.MUTANTS)
