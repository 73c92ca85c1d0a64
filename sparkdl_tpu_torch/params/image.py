"""Image-loading param mixin — counterpart of
``sparkdl_tpu/params/image.py`` (the reference's ``CanLoadImage``):
stages that read a column of image URIs through a user-supplied
``imageLoader(uri) -> ndarray``."""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from sparkdl_tpu_torch.data.frame import column
from sparkdl_tpu_torch.data.tensors import append_tensor_column
from sparkdl_tpu_torch.params.base import Param, Params, TypeConverters


@dataclasses.dataclass(frozen=True)
class LoadImages:
    """The host stage: the loader mapped over the URI column, the rows
    stacked as float32 into ``out_col``. It holds only the loader, so a
    module-level loader ships to the host pipeline's worker processes."""
    uri_col: str
    out_col: str
    loader: Callable

    def __call__(self, batch):
        uris = list(column(batch, self.uri_col))
        arrs = [np.asarray(self.loader(u), dtype=np.float32) for u in uris]
        if not arrs:
            stacked = np.zeros((0, 1), dtype=np.float32)
        else:
            first = arrs[0].shape
            bad = next((i for i, a in enumerate(arrs) if a.shape != first),
                       None)
            if bad is not None:
                # np.stack's bare "all input arrays must have the same
                # shape" names neither the loader nor the row
                raise ValueError(
                    f"imageLoader returned differing shapes: row 0 is "
                    f"{first} but row {bad} ({uris[bad]!r}) is "
                    f"{arrs[bad].shape}; the loader must produce one "
                    "fixed shape (resize inside it)")
            stacked = np.stack(arrs)
        return append_tensor_column(batch, self.out_col, stacked)


class CanLoadImage(Params):
    """Mixin for stages taking an image-URI column plus a loader:
    ``imageLoader`` maps a URI string to a float or uint8 ndarray of the
    model's HWC input shape, run on the host stages."""

    imageLoader = Param("CanLoadImage", "imageLoader",
                        "callable(uri: str) -> np.ndarray (HWC)",
                        TypeConverters.toCallable)

    def setImageLoader(self, value):
        return self._set(imageLoader=value)

    def getImageLoader(self):
        return self.getOrDefault("imageLoader")

    def loadImagesInternal(self, dataframe, uri_col: str, out_col: str):
        """Append a decoded-tensor column by mapping the loader over the
        URI column in a host stage."""
        return dataframe.map_batches(
            LoadImages(uri_col, out_col, self.getImageLoader()),
            name="loadImages")
