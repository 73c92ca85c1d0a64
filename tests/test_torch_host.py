"""The port's host path against the JAX package's on the CPU: the native
shim (``sparkdl_tpu_torch/native``, a copy of the JAX package's C++
source), ``readImagesPacked`` over one directory of PIL-written JPEGs, a
PNG and corrupt files, and the 4:2:0 codecs. The shim is the same C++
source on both sides and the PIL steps are the same calls, so every
comparison here is byte for byte."""

import sys

import numpy as np
import pytest

SIZE = (24, 32)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """JPEGs of several sizes (big enough for the DCT prescale to engage
    at SIZE, and one smaller than SIZE), one PNG, a truncated JPEG and a
    file that is no image at all."""
    from PIL import Image
    d = tmp_path_factory.mktemp("torch_host_images")
    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[0:200, 0:240]
    for i, (h, w) in enumerate([(200, 240), (120, 96), (64, 80),
                                (18, 20), (97, 131)]):
        img = np.stack([128 + 100 * np.sin(xx[:h, :w] / (5.0 + i) + c)
                        for c in range(3)], -1)
        img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255)
        Image.fromarray(img.astype(np.uint8), "RGB").save(
            d / f"img_{i}.jpg", quality=90)
    Image.fromarray(rng.integers(0, 256, (40, 30, 3), dtype=np.uint8),
                    "RGB").save(d / "lossless.png")
    blob = (d / "img_0.jpg").read_bytes()
    (d / "truncated.jpg").write_bytes(blob[:200])
    (d / "junk.jpg").write_bytes(b"not an image at all")
    return str(d)


def _read_both(image_dir, **kw):
    from sparkdl_tpu.data.tensors import arrow_to_tensor
    from sparkdl_tpu.image import imageIO as jax_io
    import sparkdl_tpu_torch
    table = jax_io.readImagesPacked(image_dir, SIZE, numPartitions=3,
                                    **kw).collect()
    idx = table.schema.get_field_index("image")
    ref = {"filePath": table.column("filePath").to_pylist(),
           "image": arrow_to_tensor(table.column(idx),
                                    table.schema.field(idx))}
    if "imageOk" in table.schema.names:
        ref["imageOk"] = np.asarray(table.column("imageOk").to_pylist())
    got = sparkdl_tpu_torch.readImagesPacked(image_dir, SIZE,
                                             numPartitions=3, **kw).collect()
    return got, ref


@pytest.mark.parametrize("drop", [True, False], ids=["drop", "keep"])
@pytest.mark.parametrize("scaled", [True, False], ids=["scaled", "full"])
@pytest.mark.parametrize("fmt", ["rgb", "yuv420"])
def test_read_images_packed_matches_jax(image_dir, fmt, scaled, drop):
    from sparkdl_tpu_torch import native
    assert native.has_jpeg()  # this box has libjpeg: the shim path runs
    got, ref = _read_both(image_dir, packedFormat=fmt, scaledDecode=scaled,
                          dropImageFailures=drop)
    assert list(got["filePath"]) == ref["filePath"]
    row = (SIZE[0] * SIZE[1] * 3 // 2,) if fmt == "yuv420" else (*SIZE, 3)
    assert got["image"].shape == (len(ref["filePath"]), *row)
    assert got["image"].dtype == np.uint8
    np.testing.assert_array_equal(got["image"], ref["image"])
    bad = ["junk" in p or "truncated" in p for p in got["filePath"]]
    if drop:
        assert not any(bad) and len(got["filePath"]) == 6
        assert "imageOk" not in got
    else:
        assert len(got["filePath"]) == 8
        np.testing.assert_array_equal(got["imageOk"], ref["imageOk"])
        np.testing.assert_array_equal(got["imageOk"], ~np.asarray(bad))
        assert not got["image"][np.asarray(bad)].any()


@pytest.mark.parametrize("fmt", ["rgb", "yuv420"])
def test_read_images_packed_pil_path_matches_jax(image_dir, fmt,
                                                 monkeypatch):
    """Without the shim's libjpeg, JPEGs take PIL's draft decode on both
    sides, as the PNG does on every run."""
    from sparkdl_tpu_torch import native
    monkeypatch.setattr(native, "has_jpeg", lambda: False)
    monkeypatch.setenv("SPARKDL_TPU_NO_NATIVE", "1")
    got, ref = _read_both(image_dir, packedFormat=fmt)
    assert list(got["filePath"]) == ref["filePath"]
    np.testing.assert_array_equal(got["image"], ref["image"])


def test_read_images_packed_needs_pil_or_the_shims_libjpeg(image_dir,
                                                           monkeypatch):
    """With neither, the read raises ImportError instead of dropping every
    row."""
    import sparkdl_tpu_torch
    from sparkdl_tpu_torch import native
    monkeypatch.setattr(native, "has_jpeg", lambda: False)
    monkeypatch.setitem(sys.modules, "PIL", None)
    df = sparkdl_tpu_torch.readImagesPacked(image_dir, SIZE,
                                            packedFormat="yuv420")
    with pytest.raises(ImportError):
        df.collect()


def test_read_images_packed_refuses_what_jax_refuses(image_dir):
    import sparkdl_tpu_torch
    from sparkdl_tpu.image import imageIO as jax_io
    for kw in ({"size": (0, 4)}, {"size": (23, 32), "packedFormat":
                                   "yuv420"},
               {"size": SIZE, "packedFormat": "yuv420", "nChannels": 1},
               {"size": SIZE, "packedFormat": "bgr"}):
        with pytest.raises(ValueError) as jax_err:
            jax_io.readImagesPacked(image_dir, **kw)
        with pytest.raises(ValueError) as err:
            sparkdl_tpu_torch.readImagesPacked(image_dir, **kw)
        assert str(err.value) == str(jax_err.value)


def test_rgb_to_yuv420_and_back_match_jax():
    from sparkdl_tpu.image import imageIO as jax_io
    from sparkdl_tpu.native import yuv420_packed_size as jax_size
    from sparkdl_tpu_torch.image import imageIO
    from sparkdl_tpu_torch.native import yuv420_packed_size
    rng = np.random.default_rng(22)
    for h, w in [(2, 2), (24, 32), (150, 150), (46, 62)]:
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        packed = imageIO.rgbToYuv420(arr)
        np.testing.assert_array_equal(packed, jax_io.rgbToYuv420(arr))
        assert packed.shape == (yuv420_packed_size(h, w),) == (jax_size(h,
                                                                        w),)
        np.testing.assert_array_equal(imageIO.yuv420ToRgb(packed, h, w),
                                      jax_io.yuv420ToRgb(packed, h, w))
    for bad in (rng.integers(0, 256, (3, 4, 3), dtype=np.uint8),
                np.zeros((4, 4, 4), np.uint8), np.zeros((4, 4, 3))):
        with pytest.raises(ValueError) as jax_err:
            jax_io.rgbToYuv420(bad)
        with pytest.raises(ValueError) as err:
            imageIO.rgbToYuv420(bad)
        assert str(err.value) == str(jax_err.value)


def test_shim_decode_resize_pack_matches_jax(image_dir):
    """The port's bindings call the same entry points with the same
    arguments as the JAX package's."""
    import glob
    import os
    from sparkdl_tpu import native as jax_native
    from sparkdl_tpu_torch import native
    blobs = [open(p, "rb").read()
             for p in sorted(glob.glob(os.path.join(image_dir, "*")))]
    for scaled in (False, True):
        got = native.decode_resize_pack_420(blobs, *SIZE,
                                            scaled_decode=scaled)
        ref = jax_native.decode_resize_pack_420(blobs, *SIZE,
                                                scaled_decode=scaled)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        got = native.decode_resize_pack(blobs, *SIZE, 1,
                                        scaled_decode=scaled)
        ref = jax_native.decode_resize_pack(blobs, *SIZE, 1,
                                            scaled_decode=scaled)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    tag, flags = native._ATTEMPTS[0]
    assert native.library_path(tag, flags).startswith(native.BUILD_DIR)
    assert os.path.exists(native.library_path(tag, flags))


def test_shim_names_each_build_and_prefers_libjpeg(tmp_path, monkeypatch):
    """A failed libjpeg build leaves the shim without JPEG under a name of
    its own, and does not pin it: once the libjpeg build works, the next
    process takes it."""
    import os
    from sparkdl_tpu_torch import native
    (tag, flags), plain = native._ATTEMPTS
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    for attempts, jpeg in (
            (((tag, flags + ["-lsparkdl_no_such_library"]), plain), False),
            (native._ATTEMPTS, True)):
        monkeypatch.setattr(native, "_ATTEMPTS", attempts)
        monkeypatch.setattr(native, "_tried", False)
        monkeypatch.setattr(native, "_lib", None)
        assert native.has_jpeg() is jpeg
        paths = [native.library_path(*a) for a in attempts]
        assert [os.path.exists(p) for p in paths] == [jpeg, True]
        assert len(set(paths)) == 2


def test_textured_image_matches_jax():
    """The port's copy of the synthetic image generator (chip_smoke.py's
    headline images) draws the same pixels from the same seed."""
    from sparkdl_tpu.utils.synth import textured_image as jax_textured
    from sparkdl_tpu_torch.utils.synth import textured_image
    for h, w in [(150, 150), (31, 46)]:
        np.testing.assert_array_equal(
            textured_image(np.random.default_rng(5), h, w),
            jax_textured(np.random.default_rng(5), h, w))
