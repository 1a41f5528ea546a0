"""Runnable examples of the port, the counterparts of the JAX package's
``examples/``: ``python -m mfcc_tpu_torch.examples.<name>`` for
``quickstart``, ``int_walkthrough``, ``serving_demo`` and
``server_loadtest``.  Each runs on the CUDA card unless given
``--backend cpu``."""
