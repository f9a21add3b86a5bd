"""Plain float32 references of the served models, one module per model
family, named by a configuration's ``"reference"`` key.  They import
nothing of the program and read only the benchmark's weights and the
token ids that were served."""
