"""Dataset and labeling toolchain: label validation, splits, CSV and settings
files, and the labeling session; the counterpart of the JAX package's
``data/``."""
