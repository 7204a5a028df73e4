"""Random words for the wavefront engine, drawn from an explicit
``torch.Generator``.

rtjax derives each iteration's words from a threefry key
(rtjax.core.rng.bits_block); torch's generators give other numbers from the
same seed, so parity between the packages is statistical.  Tests inject
rtjax's own words into :func:`rtjax_torch.render.wavefront.wavefront_step`
and compare state for state.

Words are unsigned 32-bit values carried in int64: torch's uint32 supports
few operators.
"""

from __future__ import annotations

import torch


def bits_block(generator: torch.Generator, num_words: int, n: int):
    """``[num_words, n]`` int64 tensor of uniform 32-bit words, on the
    generator's device."""
    return torch.randint(0, 1 << 32, (num_words, n), generator=generator,
                         dtype=torch.int64, device=generator.device)


def u01_pair(word):
    """32-bit word -> two U[0,1) float32 of 16-bit resolution (high half,
    low half), as rtjax.core.rng.u01_pair."""
    s = 2.0 ** -16
    return ((word >> 16).to(torch.float32) * s,
            (word & 0xFFFF).to(torch.float32) * s)
