"""The benchmark's own analytic counts of operations and bytes, one module
per model family, named by a configuration's ``"counts"`` key.  They read
only the configuration's ``model`` block and the shapes of each call."""
