"""The plain float32 reference the benchmark judges outputs by."""
