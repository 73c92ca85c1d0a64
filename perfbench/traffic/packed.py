"""Driver of the ``packed`` mixes: seeded rows as one tensor column of a
frame in ``partitions`` partitions, through ``TensorTransformer`` over
the zoo's function wrapped by ``deviceResizeModel`` (K2 for 4:2:0 rows,
K1 for RGB), collected in whole passes (``passes.py``)."""

from perfbench import inputs, passes, program


def rows(ctx):
    """The frame's rows, as the program and the reference get them."""
    mix = ctx.cell.mix
    return inputs.rows(ctx.seed, mix["rows"], mix["format"], mix["src_hw"],
                       ctx.device)


def setup(ctx) -> passes.Batch:
    from sparkdl_tpu_torch import DataFrame, TensorTransformer
    cfg, mix = ctx.cell.config, ctx.cell.mix
    state = program.seed_weights(ctx)
    ctx.mark("weights")
    data = rows(ctx)
    ctx.mark("inputs")
    df = DataFrame.from_columns({"image": data},
                                num_partitions=mix["partitions"])
    transformer = TensorTransformer(
        modelFunction=program.model_function(ctx),
        inputMapping={"image": "image"},
        outputMapping={cfg["output"]: "out"}, batchSize=mix["batch"])
    st = passes.Batch(planned=transformer.transform(df), out_col="out",
                      rows=data, metrics=transformer.metrics, state=state)
    ctx.mark("program")
    passes.warm(ctx, st)
    ctx.mark("warm")
    return st


measure = passes.measure
compare = passes.compare
