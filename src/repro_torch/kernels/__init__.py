"""Hand-written Hopper kernels (``csrc/``), their wrappers and plain
versions (``cvmm.py``; ``flash_attention.py`` for K7), the plan layer
around them (``ops.py``) and the pure-torch oracles (``ref.py``)."""
