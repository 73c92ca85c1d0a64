"""Batch-UDF registry and Keras image UDF registration — counterpart of
``sparkdl_tpu/udf`` (the reference's ``makeGraphUDF`` and
``registerKerasImageUDF``)."""

from sparkdl_tpu_torch.udf.keras_image_model import registerKerasImageUDF
from sparkdl_tpu_torch.udf.registry import (
    ModelUDF,
    callUDF,
    getUDF,
    listUDFs,
    makeModelUDF,
    registerUDF,
    unregisterUDF,
)

__all__ = [
    "ModelUDF",
    "makeModelUDF",
    "registerUDF",
    "registerKerasImageUDF",
    "unregisterUDF",
    "getUDF",
    "listUDFs",
    "callUDF",
]
