"""The language-model stack on torch: layers, the decoder and its KV
caches, and the LM-as-state-space-model adapter for SMC decoding."""
