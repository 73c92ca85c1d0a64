"""Pipeline transformers of the port; ``TFImageTransformer`` and
``TFTransformer`` are the reference-era names of ``ImageTransformer`` and
``TensorTransformer``, as in the JAX package's exports."""

from sparkdl_tpu_torch.transformers.named_image import (  # noqa: F401
    DeepImageFeaturizer,
    DeepImagePredictor,
)
from sparkdl_tpu_torch.transformers.image_transform import ImageTransformer  # noqa: F401
from sparkdl_tpu_torch.transformers.tensor_transform import TensorTransformer  # noqa: F401
from sparkdl_tpu_torch.transformers.keras_image import (  # noqa: F401
    KerasImageFileTransformer,
)
from sparkdl_tpu_torch.transformers.keras_tensor import KerasTransformer  # noqa: F401

TFImageTransformer = ImageTransformer
TFTransformer = TensorTransformer

__all__ = [
    "DeepImageFeaturizer",
    "DeepImagePredictor",
    "ImageTransformer",
    "TensorTransformer",
    "KerasImageFileTransformer",
    "KerasTransformer",
    "TFImageTransformer",
    "TFTransformer",
]
