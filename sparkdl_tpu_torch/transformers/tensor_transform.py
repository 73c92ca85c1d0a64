"""TensorTransformer: apply a model to numeric/tensor columns —
counterpart of ``sparkdl_tpu/transformers/tensor_transform.py``.

Maps named frame columns onto the ModelFunction's named inputs, runs it
in device batches through the batch runner, and maps named outputs back
to columns."""

from __future__ import annotations

import numpy as np

from sparkdl_tpu_torch.data.frame import column
from sparkdl_tpu_torch.data.tensors import append_tensor_column, column_to_tensor
from sparkdl_tpu_torch.params import (
    HasBatchSize,
    HasInputMapping,
    HasModelFunction,
    HasOutputMapping,
    HasTFHParams,
    Transformer,
    keyword_only,
)
from sparkdl_tpu_torch.runtime.runner import RunnerMetrics


class TensorTransformer(Transformer, HasModelFunction, HasInputMapping,
                        HasOutputMapping, HasBatchSize, HasTFHParams):
    """``inputMapping`` {column: model input}, ``outputMapping`` {model
    output: column}, ``tfHParams`` {model input: constant broadcast over
    the rows}. The model runs on its own device (a ModelFunction's
    ``device``: the card unless it was built with ``device="cpu"``).
    The JAX package's ``useMesh`` (several devices) is left out until the
    port's ``parallel/`` slice."""

    @keyword_only
    def __init__(self, *, modelFunction=None, inputMapping=None,
                 outputMapping=None, batchSize=64, tfHParams=None):
        super().__init__()
        self._setDefault(batchSize=64)
        self._set(modelFunction=modelFunction, inputMapping=inputMapping,
                  outputMapping=outputMapping, batchSize=batchSize,
                  tfHParams=tfHParams)
        self.metrics = RunnerMetrics()

    def _validate(self):
        mf = self.getModelFunction()
        in_map = self.getInputMapping()     # col -> input name
        out_map = self.getOutputMapping()   # output name -> col
        hparams = self.getTFHParams()       # input name -> constant
        missing = set(in_map.values()) - set(mf.input_names)
        if missing:
            raise ValueError(
                f"inputMapping references unknown model inputs {missing}; "
                f"model has {mf.input_names}")
        unknown_hp = set(hparams) - set(mf.input_names)
        if unknown_hp:
            raise ValueError(
                f"tfHParams references unknown model inputs {unknown_hp}; "
                f"model has {mf.input_names}")
        overlap = set(hparams) & set(in_map.values())
        if overlap:
            raise ValueError(
                f"model inputs {overlap} supplied by BOTH inputMapping "
                "and tfHParams")
        for name, value in hparams.items():
            shape, dtype = mf.input_signature[name]
            if shape is None or any(d is None for d in shape):
                continue  # dynamic per-row shape: nothing to check
            got = np.asarray(value, dtype=dtype).shape
            if got != tuple(shape):
                raise ValueError(
                    f"tfHParams[{name!r}] has shape {got}, model input "
                    f"{name!r} expects per-row shape {tuple(shape)}")
        unmapped = set(mf.input_names) - set(in_map.values()) - set(hparams)
        if unmapped:
            raise ValueError(f"model inputs {unmapped} not mapped")
        unknown_out = set(out_map) - set(mf.output_names)
        if unknown_out:
            raise ValueError(
                f"outputMapping references unknown model outputs "
                f"{unknown_out}; model has {mf.output_names}")
        return mf, in_map, out_map, hparams

    def _transform(self, dataset):
        mf, in_map, out_map, hparams = self._validate()
        from sparkdl_tpu_torch.transformers.utils import (
            make_runner,
            reshapeRows,
        )
        runner = make_runner(mf, self.getBatchSize(), metrics=self.metrics)
        sig = mf.input_signature

        def apply(batch):
            inputs = {}
            for col, input_name in in_map.items():
                arr = column_to_tensor(column(batch, col))
                shape, dtype = sig[input_name]
                # a payload that does not match the model, most often a
                # reader size/packedFormat that disagrees with
                # deviceResizeModel's, is named here, not by numpy
                inputs[input_name] = reshapeRows(
                    arr, shape, dtype,
                    lambda row_shape, got, expect, col=col,
                    input_name=input_name, shape=shape: (
                        f"column {col!r} rows carry {got} elements "
                        f"(row shape {row_shape}) but model input "
                        f"{input_name!r} expects shape {tuple(shape)} "
                        f"({expect} elements). The frame's payload "
                        "does not match this ModelFunction — check "
                        "the reader's size/packedFormat against the "
                        "model's (deviceResizeModel and "
                        "readImagesPacked must agree on both)"))
            n = len(next(iter(batch.values()))) if batch else 0
            for input_name, value in hparams.items():
                shape, dtype = sig[input_name]
                const = np.asarray(value, dtype=dtype)
                inputs[input_name] = np.broadcast_to(
                    const, (n,) + const.shape)
            outputs = runner.run(inputs)
            for output_name, col in out_map.items():
                batch = append_tensor_column(
                    batch, col, np.asarray(outputs[output_name]))
            return batch

        return dataset.map_batches(apply, name=f"apply({mf.name})")
