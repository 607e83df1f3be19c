"""ReProver in PyTorch for NVIDIA Hopper: the port of ``reprover_tpu``.

The JAX package stays the reference; this package keeps its module names so
each counterpart is easy to find, and imports neither ``jax`` nor anything of
``reprover_tpu``: the host-side code it needs (``data``, ``tokenizer``,
``prover``, the data modules) is copied here.

- ``data``       corpus DAG, premise accessibility, augmentation, pickle
                 interop (copies); ``tokenizer``: the ByT5 byte tokenizer
- ``models``     T5 (ByT5) encoder-decoder, the decoder-only causal LM
                 (serving), HF imports, weight bridge, int8/int4 weights
- ``ops``        the CUDA kernels (T5 attention forward and backward, the
                 beam-cache reorder, the w8a16/w4a16 products) and their
                 plain versions, pooling, masked top-k; ``csrc/`` holds
                 the CUDA sources
- ``generation`` beam search, the tactic generator models (ByT5 and
                 decoder-only), the streaming engines, the BPE tactic
                 tokenizer, the data module, validation and the training
                 CLI (``generation.main``); ``native``: the C++ BPE core
- ``retrieval``  premise retriever, data module, indexer CLI, validation
                 metrics, predictions and the training CLI
                 (``retrieval.main``)
- ``training``   optimizer, train state, retrieval and generation losses,
                 train step,
                 trainer loop, training-health telemetry
- ``utils``      config parsing, metric writers, checkpoints
- ``prover``     search, environments, tactic generators, inference
                 service, worker pool and the evaluation harness and CLI
"""

__version__ = "0.1.0"
