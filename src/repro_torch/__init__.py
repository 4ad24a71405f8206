"""PyTorch/CUDA port of the SPPO reference (``src/repro``), one slice at a time."""
