"""Image structs and file reading."""
