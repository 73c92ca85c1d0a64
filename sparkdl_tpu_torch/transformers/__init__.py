"""Pipeline transformers of the port."""
