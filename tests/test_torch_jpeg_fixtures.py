"""The committed JPEG fixtures (``testdata/jpeg/``) still hold what the
card's decode check trusts them for: each committed crop equals PIL's
decode of the committed file (the ``pil`` backend's eval crop, exact), PIL
refuses the corrupt one, and the set covers grey, 4:2:0, 4:4:4,
progressive, small and odd sizes in under 64 KB."""

import io

import numpy as np
import pytest
from PIL import Image

from multimodal_content_moderation_tpu.data.images import ImagePreprocessor as JPre
from multimodal_content_moderation_tpu_torch.testdata import CROP_SIZES, jpeg_fixtures, pil_crops
from multimodal_content_moderation_tpu_torch.testdata.make_jpegs import FIXTURES, pil_crop


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_committed_crops_equal_the_pil_decode(name):
    data = jpeg_fixtures()[name].read_bytes()
    crops = pil_crops(name)
    for size in CROP_SIZES:
        np.testing.assert_array_equal(crops[size], pil_crop(data, size))
        # the JAX package's pil backend gives the same crop
        want, present = JPre(size, size, output="uint8_hwc").process_bytes(data)
        assert present == 1.0
        np.testing.assert_array_equal(crops[size], want)


def test_fixture_set():
    files = jpeg_fixtures()
    assert set(files) == set(FIXTURES) | {"corrupt"}
    assert sum(p.stat().st_size for p in files.values()) < 64 * 1024
    with pytest.raises(Exception):
        pil_crop(files["corrupt"].read_bytes(), 224)
    modes, subsampling = set(), set()
    for name in FIXTURES:
        with Image.open(io.BytesIO(files[name].read_bytes())) as im:
            modes.add(im.mode)
            if im.mode == "RGB":
                from PIL import JpegImagePlugin

                subsampling.add(JpegImagePlugin.get_sampling(im))
            assert (im.height, im.width) == FIXTURES[name][:2]
    assert modes == {"L", "RGB"} and {0, 2} <= subsampling
    assert any(f[5] for f in FIXTURES.values())  # a progressive one
