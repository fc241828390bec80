"""Seeded cuts and bit flips of JPEG 2000 uploads against Pillow 12.1
with openjpeg 2.5.4, the bar of `test_torch_jpeg2000.py`'s `same`: equal
RGB bytes where Pillow decodes, a refusal where it refuses. Each committed
fixture takes 1000 (500 cuts, 500 flips); the two 250x2500 strips, whose
flips each decode 188 KB, take 500 cuts and 8 flips, and a 96x192 crop of
the strip in each strip's coding takes the full 1000."""

import os

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_jpeg2000 import (_FUZZ, _STRIP_CODINGS, _save, _strip,
                                       cases, same)
from tests.test_torch_tiff import FIXTURES


@pytest.mark.parametrize("name, cuts, flips", _FUZZ)
def test_fixture_cuts_and_flips(name, cuts, flips):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    seen = {}
    for case in cases(data, sum(name.encode()), cuts, flips):
        r = same(case)
        seen[r] = seen.get(r, 0) + 1
    assert seen.get("decoded", 0) > 0 and seen.get("refused", 0) > 0


@pytest.mark.parametrize("name", sorted(_STRIP_CODINGS))
def test_strip_codings_cut_and_flipped(name):
    """The strips' flips each decode the whole strip, so each strip's
    coding takes its 1000 cuts and flips on a 96x192 crop of the strip
    with traces in it, coded as that strip is."""
    crop = np.ascontiguousarray(_strip()[76:172, 592:784])
    data = _save(Image.fromarray(crop), **_STRIP_CODINGS[name])
    assert same(data) == "decoded"
    seen = {}
    for case in cases(data, sum(name.encode()) + 1, 500, 500):
        r = same(case)
        seen[r] = seen.get(r, 0) + 1
    assert seen.get("decoded", 0) > 0 and seen.get("refused", 0) > 0
