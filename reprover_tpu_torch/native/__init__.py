"""Native (C++) components: the BPE tokenizer core (a copy of the JAX
package's), built under ``build/native/`` at first use."""

from reprover_tpu_torch.native.bpe import BpeTokenizer, native_available

__all__ = ["BpeTokenizer", "native_available"]
