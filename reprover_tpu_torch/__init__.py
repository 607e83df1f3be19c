"""ReProver in PyTorch for NVIDIA Hopper: the port of ``reprover_tpu``.

The JAX package stays the reference; this package keeps its module names so
each counterpart is easy to find, and never imports ``jax``. Host-side code
that imports no JAX (``reprover_tpu.data``, ``reprover_tpu.tokenizer``,
``reprover_tpu.prover``) is reused by import.

- ``models``     T5 (ByT5) encoder-decoder, HF import, weight bridge
- ``ops``        the encoder-attention CUDA kernels (forward and backward)
                 and their plain versions, pooling, masked top-k; ``csrc/``
                 holds the CUDA sources
- ``generation`` beam search and the tactic generator model
- ``retrieval``  premise retriever, indexer CLI, validation metrics and
                 the retriever-training CLI (``retrieval.main``)
- ``training``   optimizer, train state, retrieval losses, train step,
                 trainer loop, training-health telemetry
- ``utils``      config parsing, metric writers, checkpoints
- ``prover``     tactic generators on the port's models and the
                 evaluation CLI
"""

__version__ = "0.1.0"
